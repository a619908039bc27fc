"""Mixtral-8x7B [arXiv:2401.04088] — 8 experts top-2 MoE with sliding-window
attention (4096). 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
Also one of RAGCache's own large-model evaluation targets (paper §7.2)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    moe_experts=8,
    moe_top_k=2,
    sliding_window=4096,
    global_every=0,          # SWA on every layer
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, name="mixtral-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512, moe_experts=4, sliding_window=64,
)
