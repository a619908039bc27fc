"""Synthetic corpus, workloads and the host-side vector index."""
