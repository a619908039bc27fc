"""Assigned input shapes and the compile analysis's inputs (counterpart of
``repro.launch.specs``).

``SHAPES``, ``supports_long_context`` and ``shape_applicable`` are the
reference's.  ``input_specs`` returns ``(step_fn, args, donate,
out_layout)`` as the reference's does, but where the reference hands XLA
``ShapeDtypeStruct``s carrying ``NamedSharding``s, the port's args are
tensors placed on the mesh's devices in the training layout
(``launch/sharding.py::place_train``): created in whatever mode is
active, so under ``FakeTensorMode`` (``launch/dryrun.py``) they are fake
tensors that allocate nothing.  ``global_specs`` gives each argument's
global shape, dtype and spec in the reference's trees, the figures its
``ShapeDtypeStruct``s carry.

The kinds run the reference's steps in the training layout: ``train``
``train_lib.make_train_step(mesh=)``; ``prefill``
``models/model.py::replica_prefill`` over replica 0's shards (the data
replicas of a divisible batch do the same work, and an indivisible one
runs on replica 0 alone); ``decode`` ``replica_decode_step`` over the
whole mesh, its cache laid out by ``launch/sharding.py::cache_layout``
(replica 0's rows of a divisible batch; else the sequence split over the
data replicas, each attending to its slice).  ``computed=1`` traces
replica 0 only, the others standing in: their grads in the train step
(``train_lib.sharded_loss_and_grads``), their slices' partial attention
in the decode step; ``None`` runs every replica.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_lib import make_train_step

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    dict(kind="train",  seq=4_096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k":  dict(kind="decode", seq=32_768,  batch=128),
    "long_500k":   dict(kind="decode", seq=524_288, batch=1),
}


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic/bounded-KV archs (docs/ARCHITECTURE.md §4):
    SSM/hybrid (O(1)/windowed state) and dense archs with sliding windows."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.sliding_window > 0


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not supports_long_context(cfg):
        return False, ("pure full-attention arch: 500k decode skipped per "
                       "assignment rule (docs/ARCHITECTURE.md §4)")
    return True, ""


def _info(shape) -> Dict[str, Any]:
    return SHAPES[shape] if isinstance(shape, str) else dict(shape)


def _tok_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, tuple]:
    """The token-side inputs' (shape, dtype) (the reference's
    ``_tok_struct``)."""
    if cfg.n_codebooks:
        return {"tokens": ((batch, cfg.n_codebooks, seq), torch.int32)}
    if cfg.family == "vlm":
        vt = cfg.vision_tokens
        return {"tokens": ((batch, seq - vt), torch.int32),
                "patch_embeds": ((batch, vt, cfg.d_model), torch.float32)}
    return {"tokens": ((batch, seq), torch.int32)}


def _batch_shapes(cfg: ModelConfig, info) -> Dict[str, tuple]:
    batch, seq = info["batch"], info["seq"]
    out = _tok_shapes(cfg, batch, seq)
    if info["kind"] == "train":
        out["labels"] = out["tokens"]
        if cfg.family == "vlm":
            out["labels"] = ((batch, seq), torch.int32)
            out["loss_mask"] = ((batch, seq), torch.float32)
    return out


def _decode_shapes(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    tok = (batch, cfg.n_codebooks, 1) if cfg.n_codebooks else (batch, 1)
    return {"tokens": (tok, torch.int32), "pos": ((batch,), torch.int32)}


def global_specs(cfg: ModelConfig, shape, mesh,
                 opts: SH.Options = SH.NO_OPTIONS) -> Dict[str, Any]:
    """Every argument's global (shape, dtype, spec), by the reference's
    trees: {"params": {path: ...}, and per kind "opt" ({"m"/"v": {path:
    ...}}), "batch" ({name: ...}), "cache" ({path: ...}), "tokens",
    "pos"}.  Specs are ``launch/sharding.py``'s tuples."""
    info = _info(shape)
    tree = M.init_params(cfg, 0, device="meta")
    fb = opts.attn_fallback
    out = {"params": {p: (tuple(l.shape), l.dtype,
                          SH.param_spec(p, l, cfg, mesh, fb))
                      for p, l in SH._leaves(tree)}}
    bax, _ = SH.batch_spec(cfg, info["batch"], mesh)
    if info["kind"] == "decode":
        cache = M.init_decode_cache(cfg, info["batch"], info["seq"],
                                    device="meta")
        specs = SH.cache_shardings(cfg, cache, mesh, info["batch"])
        out["cache"] = {}

        def walk(node, sp, path=()):
            if node is None:
                return
            if isinstance(node, torch.Tensor):
                out["cache"][path] = (tuple(node.shape), node.dtype, sp)
                return
            keys = (sorted(node) if isinstance(node, dict)
                    else range(len(node)))
            for k in keys:
                walk(node[k], sp[k], path + (str(k),))

        walk(cache, specs)
        for name, (sh, dt) in _decode_shapes(cfg, info["batch"]).items():
            out[name] = (sh, dt, (bax,) + (None,) * (len(sh) - 1))
        return out
    out["batch"] = {name: (sh, dt, (bax,) + (None,) * (len(sh) - 1))
                    for name, (sh, dt) in _batch_shapes(cfg, info).items()}
    if info["kind"] == "train":
        out["opt"] = {w: {p: (tuple(l.shape), torch.float32, SH.opt_spec(
            SH.param_spec(p, l, cfg, mesh, fb), l, mesh))
            for p, l in SH._leaves(tree)} for w in ("m", "v")}
    return out


def _empty(shape, dtype, device) -> torch.Tensor:
    """An uninitialised tensor (a fake one under ``FakeTensorMode``); ints
    are zeros (token ids must index the vocabulary on real tensors)."""
    if dtype in (torch.int32, torch.int64):
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.empty(shape, dtype=dtype, device=device)


def _whole_params(cfg: ModelConfig, device) -> Dict[str, Any]:
    """The model's tree as uninitialised tensors on ``device``."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else _empty(v.shape, v.dtype, device)
                for k, v in node.items()}
    return walk(M.init_params(cfg, 0, device="meta"))


def _parts(cfg: ModelConfig, shapes: Dict[str, tuple], mesh) -> list:
    """Each computing replica's rows of inputs of global ``shapes`` on its
    controller: the data axes' share when they divide the batch, else the
    whole batch on replica 0 alone."""
    B = next(iter(shapes.values()))[0][0]
    bax, n = SH.batch_spec(cfg, B, mesh)
    if bax is None:
        n = 1
    return [{k: _empty((sh[0] // n,) + tuple(sh[1:]), dt,
                       mesh.replica(d).controller)
             for k, (sh, dt) in shapes.items()} for d in range(n)]


def input_specs(cfg: ModelConfig, shape, mesh,
                opts: SH.Options = SH.NO_OPTIONS, computed=1,
                params=None):
    """(step_fn, args, donate, out_layout) for ``shape`` (a ``SHAPES``
    name, or a dict of kind, seq and batch) over ``mesh`` (a
    ``DeviceMesh``).  ``params``: the whole tree (on any device) to place;
    uninitialised tensors of the model's shapes by default.  ``donate``
    names the args the reference donates (the port's steps only read
    them); ``out_layout`` says where the outputs lie."""
    info = _info(shape)
    kind, seq, batch = info["kind"], info["seq"], info["batch"]
    ctl = mesh.replica(0).controller
    if params is None:
        params = _whole_params(cfg, ctl)
    placed = SH.place_train(params, cfg, mesh, opts)

    if kind == "train":
        dims = SH.train_dims(cfg, mesh, opts)
        state = OPT.init_state_zero(dims, placed, mesh)
        step = make_train_step(cfg, OPT.AdamWConfig(), mesh=mesh, opts=opts,
                               computed=computed)
        parts = _parts(cfg, _batch_shapes(cfg, info), mesh)
        return (step, (placed, state, parts), (0, 1),
                "params and moments in the training layout; loss and grad "
                "norm on replica 0's controller")

    row = mesh.replica(0)
    tree = M.with_slices(placed, 0, SH.train_dims(cfg, mesh, opts))
    if kind == "prefill":
        part = _parts(cfg, _batch_shapes(cfg, info), mesh)[0]

        def prefill_step(params, batch):
            with torch.no_grad():
                return M.replica_prefill(cfg, params, batch, mesh=row,
                                         opts=opts)
        return (prefill_step, (tree, part), (),
                "logits on replica 0's controller; the cache as "
                "replica_decode_cache lays it out")

    part = _parts(cfg, _decode_shapes(cfg, batch), mesh)[0]
    cache = M.replica_decode_cache(cfg, batch, seq, params=tree, mesh=mesh,
                                   opts=opts)

    def serve_step(params, tokens, cache, pos):
        with torch.no_grad():
            return M.replica_decode_step(cfg, params, tokens, cache, pos,
                                         mesh=mesh, opts=opts,
                                         computed=computed)
    return (serve_step, (tree, part["tokens"], cache, part["pos"]),
            (2,), "logits on replica 0's controller; the cache written in "
            "place, laid out by sharding.cache_layout")
