"""Yi-34B [arXiv:2403.04652] — llama-architecture dense GQA.
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, name="yi-reduced", n_layers=2, d_model=448, n_heads=7,
    n_kv_heads=1, d_ff=1024, vocab_size=512,
)
