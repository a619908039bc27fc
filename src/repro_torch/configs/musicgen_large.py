"""MusicGen-large [arXiv:2306.05284] — decoder-only LM over EnCodec tokens,
4 codebooks (delay interleaving handled by the data pipeline), MHA.
48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 per codebook.
The EnCodec conv codec is a stub frontend per the carve-out; the model
consumes/produces codebook token ids."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, name="musicgen-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=4, d_ff=512, vocab_size=128, n_codebooks=4,
)
