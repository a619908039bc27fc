"""Training entry point: trains a reduced model on the synthetic LM stream
with AdamW, a cosine schedule and periodic flat-npz checkpoints
(counterpart of ``repro.launch.train``, with its flags, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-0.5b --steps 300 --batch 8 --seq 128

``--device`` defaults to ``cuda``: on the card the forward's attention is
the prefix-attention kernel (``kernels/csrc/prefix_attention.cu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.models import model as M
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, make_batches
from repro_torch.training.optimizer import (AdamWConfig, init_state,
                                            tree_leaves)
from repro_torch.training.train_lib import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (0 = reduced config default)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return ap


def main(argv=None) -> list:
    """Trains; returns the logged (step, loss) pairs."""
    args = build_parser().parse_args(argv)
    cfg = get_reduced(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = torch.device(args.device)
    params = M.init_params(cfg, 0, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model={cfg.name} params={n_params / 1e6:.1f}M "
          f"device={device}")
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                      total_steps=args.steps)
    state = init_state(params)
    step_fn = make_train_step(cfg, opt)
    data = make_batches(DataConfig(batch_size=args.batch, seq_len=args.seq,
                                   vocab_size=cfg.vocab_size), cfg)
    logged = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        params, state, metrics = step_fn(params, state, batch)
        if step % args.log_every == 0 or step == 1:
            loss = float(metrics["loss"])
            tok_s = args.batch * args.seq * step / (time.time() - t0)
            print(f"step {step:>5}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"tok/s {tok_s:,.0f}", flush=True)
            logged.append((step, loss))
        if args.ckpt and step % args.ckpt_every == 0:
            ckpt.save(f"{args.ckpt}/step{step}", params, step=step)
            print(f"checkpointed -> {args.ckpt}/step{step}.npz")
    return logged


if __name__ == "__main__":
    main()
