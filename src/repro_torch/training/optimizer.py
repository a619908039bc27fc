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

On a ``(data, model)`` mesh (``launch/sharding.py::place_train``'s
layout) the moments are ZeRO-1 slices (``init_state_zero``): each device
keeps the slice of its param shard that ``opt_spec``'s data dim gives its
replica.  ``apply_updates_zero`` sums each shard's gradient over the data
replicas onto the owner of each slice (a reduce-scatter), takes the norm
of the whole gradient from those slices (each piece once), updates each
slice where it lives, and gathers the slices into every replica's copy,
so every replica holds the same param bits.  A leaf the data axes split
(``launch/sharding.py::Options.attn_fallback``) is its replica's slice
already: its moments take the slice's shape, each replica's gradient of
it comes as one part per owner's slice (on the owner's controller), and
the updated slice stays where it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Mapping, NamedTuple

import torch

from repro_torch.launch import op_analysis


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
    """The tensors of a nested dict (and of the lists and tuples in it:
    a placed leaf's shards), in sorted-key order."""
    if isinstance(tree, Mapping):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
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
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf, on
    the first leaf's device.  A tensor that appears more than once (a
    replicated leaf that several shards' trees share) counts once."""
    total, seen = None, set()
    for x in tree_leaves(tree):
        if id(x) in seen:
            continue
        seen.add(id(x))
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


def _adamw(cfg: AdamWConfig, p, g, m, v, lr, clip, bc1, bc2, ndim: int):
    """One leaf's (or one slice's) AdamW update: (new p, m, v).  ``ndim``
    is the whole leaf's, which decides the decay."""
    g = g.float() * clip
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    if ndim >= 2:               # decoupled weight decay on matrices only
        delta = delta + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


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
        return _adamw(cfg, p, g, m, v, lr, clip, bc1, bc2, p.dim())

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(step=step, m=_pick(out, 1),
                                     v=_pick(out, 2)), gnorm


def _pick(tree, i):
    """Element ``i`` of each (param, m, v) tuple of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# ZeRO-1 on a (data, model) mesh
# ---------------------------------------------------------------------------


def _parts(leaf) -> tuple:
    """A placed leaf's model shards (one for a replicated leaf)."""
    return leaf if isinstance(leaf, tuple) else (leaf,)


def _placed(parts: list, like):
    return tuple(parts) if isinstance(like, tuple) else parts[0]


def _paths(tree, path=()):
    """The leaf paths of a nested dict, in sorted-key order."""
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            yield from _paths(tree[k], path + (k,))
        else:
            yield path + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _slice(t: torch.Tensor, dd: int, n: int, d: int) -> torch.Tensor:
    """Replica ``d``'s ZeRO-1 slice of ``t`` along ``dd`` (all of it when
    the moments have no data dim; ``opt_spec`` picks only dims that ``n``
    divides)."""
    if dd < 0:
        return t
    size = t.shape[dd] // n
    return t.narrow(dd, d * size, size)


def init_state_zero(dims, params: list, mesh) -> AdamWState:
    """f32 zero moments in ZeRO-1 slices for ``place_train``'s list over
    ``mesh``: replica d's trees hold, for each shard of each leaf, the
    slice ``opt_spec`` gives it (the whole shard when no dim divides; a
    data-split leaf's own slice), on the shard's device.  ``dims``:
    ``launch/sharding.py::train_dims`` of the model over ``mesh``.  The
    step counter lives on replica 0's controller."""
    n = mesh.n_replicas

    def zeros(d):
        out = {}
        for path in _paths(params[d]):
            leaf, (_, dd, split) = _get(params[d], path), dims[path]
            cut = -1 if split else dd
            _put(out, path, _placed(
                [torch.zeros(_slice(t, cut, n, d).shape, dtype=torch.float32,
                             device=t.device) for t in _parts(leaf)], leaf))
        return out

    m = [zeros(d) for d in range(n)]
    v = [zeros(d) for d in range(n)]
    step = torch.zeros((), dtype=torch.int32,
                       device=mesh.replica(0).controller)
    return AdamWState(step=step, m=m, v=v)


@torch.no_grad()
def apply_updates_zero(cfg: AdamWConfig, dims, mesh, params: list,
                       grads: list, state: AdamWState, traced=None):
    """One AdamW step over ZeRO-1 slices.  ``params``: ``place_train``'s
    list (one placed tree a data replica); ``grads``: the replicas' grads
    in the same layout (one tree per replica that computed a share of the
    loss; a data-split leaf's as a tuple of one part per replica's
    slice); ``state``: ``init_state_zero``'s; ``dims``: as there.
    Returns (new params, new state, grad norm on replica 0's controller):
    new tensors.

    ``traced``: the compile analysis's count of replicas it traces (the
    first ones); every other replica's own sums and updates stand in as
    empty tensors of their shapes, and only the copies to and from the
    traced replicas are made, so the traced cards see the whole mesh's
    transfers and memory in O(replicas) ops a slice, not O(replicas^2)."""
    n = mesh.n_replicas
    traced = n if traced is None else traced
    ctl = mesh.replica(0).controller
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    paths = list(_paths(params[0]))
    # the reduce-scatter: each slice's gradient summed over the replicas in
    # replica order, on the device that owns the slice
    reduced, pieces = {}, []
    for path in paths:
        _, dd, split = dims[path]
        kind = "all-reduce" if dd < 0 else "reduce-scatter"
        for i in range(len(_parts(_get(params[0], path)))):
            sums = []
            for d in range(n):
                dev = _parts(_get(params[d], path))[i].device
                total = None
                for g in (grads if d < traced else grads[:traced]):
                    s = op_analysis.to(
                        _get(g, path)[d] if split else
                        _slice(_parts(_get(g, path))[i], dd, n, d), dev,
                        kind)
                    total = s if total is None else total + s
                sums.append(total)
            reduced[path, i] = sums
            pieces += sums if dd >= 0 else sums[:1]
    gnorm = global_norm(pieces).to(ctl)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    new_p = [{} for _ in range(n)]
    new_m = [{} for _ in range(n)]
    new_v = [{} for _ in range(n)]
    for path in paths:
        _, dd, split = dims[path]
        like = _get(params[0], path)
        shards = [[] for _ in range(n)]
        moments = [([], []) for _ in range(n)]
        for i in range(len(_parts(like))):
            slices = []
            for d in range(n):
                p = _parts(_get(params[d], path))[i]
                scal = [t.to(p.device) for t in (lr, clip, bc1, bc2)]
                m = _parts(_get(state.m[d], path))[i]
                v = _parts(_get(state.v[d], path))[i]
                mine = p if split else _slice(p, dd, n, d)
                if d < traced:
                    mine, m, v = _adamw(cfg, mine, reduced[path, i][d], m, v,
                                        *scal, p.dim())
                else:
                    mine, m, v = (torch.empty_like(t) for t in (mine, m, v))
                slices.append(mine)
                moments[d][0].append(m)
                moments[d][1].append(v)
            for d in range(n):
                p = _parts(_get(params[d], path))[i]
                if dd < 0 or split:
                    shards[d].append(slices[d])
                    continue
                got = [op_analysis.to(t, p.device, "all-gather")
                       for t in (slices if d < traced else slices[:traced])]
                shards[d].append(torch.cat(got, dim=dd) if d < traced
                                 else torch.empty_like(p))
        for d in range(n):
            _put(new_p[d], path, _placed(shards[d], like))
            _put(new_m[d], path, _placed(moments[d][0], like))
            _put(new_v[d], path, _placed(moments[d][1], like))
    return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm


def gather_moments(dims, mesh, moments: list, device="cpu"):
    """One whole moment tree on ``device`` from the replicas' ZeRO-1
    slices (``init_state_zero``'s ``m`` or ``v``): the slices concatenated
    along their data dim, then the shards along their model dim
    (``dims``: as for ``init_state_zero``)."""
    n = mesh.n_replicas
    out = {}
    for path in _paths(moments[0]):
        md, dd, _ = dims[path]
        parts = []
        for i in range(len(_parts(_get(moments[0], path)))):
            sl = [_parts(_get(moments[d], path))[i].to(device)
                  for d in range(n)]
            parts.append(sl[0] if dd < 0 else torch.cat(sl, dim=dd))
        _put(out, path, parts[0] if len(parts) == 1
             else torch.cat(parts, dim=md))
    return out
