"""Mistral-7B [arXiv:2310.06825] — RAGCache's primary evaluation model
(paper Table 1): 32L, 32 Q / 8 KV heads, SWA 4096, KV 0.125 MiB/token."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    global_every=0,
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="mistral-reduced",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    sliding_window=64,
)
