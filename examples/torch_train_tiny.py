"""Train a reduced model on the synthetic LM stream with the PyTorch port's
library API (``training.train_lib.make_train_step``, AdamW, the cosine
schedule); the loss must fall.  On the card the forward's attention is the
prefix kernel (``kernels/csrc/prefix_attention.cu``); on the CPU its plain
version.

    PYTHONPATH=src python examples/torch_train_tiny.py [--steps 200] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import prefix_attention as PX
from repro_torch.models import model as M
from repro_torch.training.data import DataConfig, make_batches
from repro_torch.training.optimizer import AdamWConfig, init_state, tree_leaves
from repro_torch.training.train_lib import make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--arch", default="qwen2-0.5b")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
device = torch.device(args.device)

cfg = get_reduced(args.arch)
params = M.init_params(cfg, 0, device=device)
n = sum(t.numel() for t in tree_leaves(params))
print(f"{cfg.name}: {n / 1e6:.1f}M params on {device}")

opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
state = init_state(params)
step_fn = make_train_step(cfg, opt)
data = make_batches(
    DataConfig(batch_size=8, seq_len=64, vocab_size=cfg.vocab_size), cfg
)

first = None
t0 = time.time()
for step in range(1, args.steps + 1):
    batch = {k: torch.as_tensor(v, device=device) for k, v in next(data).items()}
    params, state, m = step_fn(params, state, batch)
    loss = float(m["loss"])
    first = first or loss
    if step % 25 == 0 or step == 1:
        print(
            f"step {step:>4} loss {loss:.4f} "
            f"({8 * 64 * step / (time.time() - t0):,.0f} tok/s)"
        )
print(f"loss {first:.3f} -> {loss:.3f}")
print(
    f"device {device}: prefix kernel launches "
    f"{PX.prefix_flash_attention.launches}, plain version calls "
    f"{PX.prefix_attention_torch.calls}"
)
assert loss < first
print("OK")
