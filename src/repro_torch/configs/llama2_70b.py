"""LLaMA2-70B [arXiv:2307.09288] — RAGCache large-model case study
(paper §7.2, Table 1): 80L, 64 Q / 8 KV heads, KV 0.3125 MiB/token."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, name="llama2-70b-reduced", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=1, d_ff=512, vocab_size=512,
)
