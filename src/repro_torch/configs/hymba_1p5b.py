"""Hymba-1.5B [arXiv:2411.13676] — hybrid-head: parallel attention + mamba
heads in every block, SWA on most layers with a few global. 32L d_model=1600
25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    sliding_window=1024,    # Hymba: SWA everywhere except a few global layers
    global_every=16,        # layers 16, 32 global (approximates first/mid/last)
)

REDUCED = dataclasses.replace(
    CONFIG, name="hymba-reduced", n_layers=2, d_model=320, n_heads=5,
    n_kv_heads=1, d_ff=512, vocab_size=512, sliding_window=64, global_every=2,
)
