"""Qwen2-0.5B [arXiv:2407.10671] — dense GQA with QKV bias.
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512,
)
