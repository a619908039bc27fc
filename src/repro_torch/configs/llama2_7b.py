"""LLaMA2-7B [arXiv:2307.09288] — RAGCache evaluation model (paper Table 1):
32L, MHA 32/32 heads, KV 0.5 MiB/token (4x Mistral's — drives the paper's
hit-rate gap between the two models)."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="llama2-reduced",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
)
