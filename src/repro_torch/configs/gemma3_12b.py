"""Gemma-3-12B [hf:google/gemma-3-1b-pt family] — 5:1 local:global attention
pattern (every 6th layer global), 1024-token sliding window on local layers,
128k context. 48L d_model=3840 16H (GQA kv=8) head_dim=256 d_ff=15360
vocab=262144."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="gemma3-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    sliding_window=64, global_every=2,
)
