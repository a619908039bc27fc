"""xLSTM-1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks (xLSTM[7:1] ratio:
every 8th block is sLSTM). 48L d_model=2048 4H vocab=50304, d_ff=0 (the
mLSTM up/down projection is the mixer)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,          # xLSTM[7:1]: 7 mLSTM then 1 sLSTM per period
    proj_factor=2.0,
    conv_kernel=4,
)

REDUCED = dataclasses.replace(
    CONFIG, name="xlstm-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=4, vocab_size=512, slstm_every=2,
)
