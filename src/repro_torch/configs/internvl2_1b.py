"""InternVL2-1B [arXiv:2404.16821] — InternViT (stub frontend) + InternLM2
backbone (llama-like GQA). 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. ``input_specs`` supplies 256 precomputed patch embeddings per
the modality-frontend carve-out."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    vision_tokens=256,
)

REDUCED = dataclasses.replace(
    CONFIG, name="internvl2-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512, vision_tokens=16,
)
