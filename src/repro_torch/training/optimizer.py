"""AdamW and its cosine schedule on tensors (counterpart of
``repro.training.optimizer``).

Params are the model's nested dict of tensors; the moments are f32 whatever
the param dtype (bf16 training).  ``apply_updates`` follows the reference's
order of operations: the global-norm clip, f32 moments, bias correction,
the decoupled decay added to ``delta`` only for tensors of two or more
dimensions, and the update cast back to the param's dtype.  It is not
``torch.optim.AdamW``, which decays every tensor and rounds in another
order.  Leaves are visited in sorted-key order, as ``jax.tree.leaves``
visits a dict, so the global norm sums them in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Mapping, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, Mapping):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), in the tree's structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def init_state(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step.  Returns (new params, new state, grad norm): new
    tensors; ``params``, ``grads`` and ``state`` are only read."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:            # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(step=step, m=_pick(out, 1),
                                     v=_pick(out, 2)), gnorm


def _pick(tree, i):
    """Element ``i`` of each (param, m, v) tuple of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
