"""Paged attention: hand-written CUDA kernels for Hopper beside plain torch versions."""
