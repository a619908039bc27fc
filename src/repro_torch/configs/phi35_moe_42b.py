"""Phi-3.5-MoE-instruct (42B total / 6.6B active)
[hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts, top-2 routing.
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe_experts=16,
    moe_top_k=2,
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, name="phi35-moe-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512, moe_experts=4,
)
