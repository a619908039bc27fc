"""Gemma-2-27B [arXiv:2408.00118] — alternating local/global attention
(every 2nd layer global), 4096 sliding window, attention-logit softcap 50,
final-logit softcap 30. 46L d_model=4608 32H (GQA kv=16) head_dim=128
d_ff=36864 vocab=256000."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,
    global_every=2,          # local, global, local, global, ...
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
)

REDUCED = dataclasses.replace(
    CONFIG, name="gemma2-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    sliding_window=64, global_every=2,
)
