"""Training: the synthetic data stream, AdamW, the chunked-vocab loss and
its train step, and flat-npz checkpoints the JAX package reads too."""
