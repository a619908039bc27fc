"""Partition rules of tensor-parallel serving (counterpart of the serving
half of ``repro.launch.sharding``).

Megatron-style tensor parallelism over the ``model`` axis:
  column-parallel: wq/wk/wv (fused head dim), wg/wu (d_ff), lm_head, and
                   the embedding's vocab dim
  row-parallel:    wo, wd (contracting dim), which serving replicates
                   (``serving_param_shardings``)
Every rule checks divisibility and falls back to replication.

A spec is a tuple naming, for each dim of a leaf, ``"model"`` (sharded
over the model axis), a data-axis name, or ``None``, as a JAX
``PartitionSpec`` does; ``()`` replicates.  ``shard_params`` turns a param
tree into one tree per shard by ``torch.chunk`` along the spec's dim.

Placement (the port's choice): the residual stream and the replicated
products (norms, wo, wd, RoPE and every elementwise op) run once, on the
mesh's first device (its controller); the column products and the paged
attention run on each shard's device.  So the replicated leaves live on the
controller only, and every shard's tree refers to that one copy; a split
leaf's parts are copies, and the column leaves are laid out slab-major
when a shard computes more than one slab of the mesh's group (``placer``).
The ragged-heads option (``ATTN_REPLICATE_IF_RAGGED``) comes with the
compile analysis, its only caller in the reference.  The
training half (``param_shardings``, ``opt_shardings``, ``input_shardings``,
``batch_spec``, ``cache_shardings``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig

# param-name kinds: "col" shards the output dim, "row" the contracting dim
_COL = {
    "wq",
    "wk",
    "wv",
    "wg",
    "wu",
    "w_up",
    "w_x",
    "router",
    "ssm_in",
    "lm_head",
    "vision_proj",
}
_ROW = {"wo", "wd", "w_down", "ssm_out"}


def _heads_tile_cleanly(cfg: ModelConfig, msize: int) -> bool:
    """True if a fused (H*hd) sharding is expressible as whole heads or an
    even intra-head split."""
    for heads in (cfg.n_heads, cfg.n_kv_heads):
        per_shard = heads * cfg.hd // msize
        if per_shard == 0:
            return False
        if per_shard % cfg.hd != 0 and cfg.hd % per_shard != 0:
            return False
    return True


def kv_heads_shardable(cfg: ModelConfig, tp: int) -> bool:
    """True when a ``tp``-way model axis splits attention into WHOLE heads:
    the paged pool's ``(L, n_blocks, block, KV, hd)`` planes shard dim 3, so
    a KV head split across devices would tear a page's head tile apart."""
    return tp >= 1 and cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0


def assert_tp_compatible(cfg: ModelConfig, tp: int) -> None:
    """Error early (before any mesh or device work) on a mesh/model pair
    that would shard a KV head across devices."""
    if tp > 1 and not kv_heads_shardable(cfg, tp):
        raise ValueError(
            f"--tp {tp} would shard a KV head across devices: {cfg.name} has "
            f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads, and the paged "
            f"pool shards whole KV heads over the model axis.  Pick tp "
            f"dividing both head counts "
            f"(e.g. {_clean_tps(cfg)})."
        )


def _clean_tps(cfg: ModelConfig, limit: int = 8) -> list:
    return [t for t in range(1, limit + 1) if kv_heads_shardable(cfg, t)]


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def _fits(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def param_spec(path: Tuple[str, ...], leaf, cfg: ModelConfig, mesh) -> tuple:
    """The spec of the leaf at ``path`` (its keys from the tree's root):
    the reference's ``param_spec`` rules, as a tuple."""
    name = path[-1]
    ndim = leaf.ndim
    msize = _axis_size(mesh, "model")
    spec = [None] * ndim

    is_expert = (
        cfg.moe_experts > 0 and name in ("wg", "wu", "wd") and "blocks" in path
    )
    if is_expert:
        # (L, E, D, F) / (L, E, F, D): expert-parallel when E % model == 0
        if _fits(cfg.moe_experts, msize):
            spec[1] = "model"
        else:
            d = ndim - 1 if name in ("wg", "wu") else ndim - 2
            if _fits(leaf.shape[d], msize):
                spec[d] = "model"
        return tuple(spec)

    if name == "embed":
        # (V, D) or (K, V, D): shard vocab
        d = ndim - 2
    elif name in _COL:
        d = ndim - 1
    elif name in _ROW:
        d = ndim - 2
    else:
        return ()  # norms, biases, gates, conv, recurrent mats: replicate
    if _fits(leaf.shape[d], msize):
        spec[d] = "model"
    return tuple(spec)


def pool_kv_spec() -> tuple:
    """Paged-pool spec: ``(L, n_blocks, block, KV, hd)`` shards whole KV
    heads over ``model``; block geometry stays replicated (block tables
    and slot mappings are the same on every shard)."""
    return (None, None, None, "model", None)


def _leaves(tree, path=()):
    """(path, leaf) of every tensor of a nested dict, in key order."""
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, path + (key,))
        else:
            yield path + (key,), node


def _map(tree, fn, path=()):
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out[key] = _map(node, fn, path + (key,))
        else:
            out[key] = fn(path + (key,), node)
    return out


def serving_param_shardings(cfg: ModelConfig, params, mesh) -> Dict[str, Any]:
    """``param_spec`` minus row parallelism, as a tree of specs: ``wo`` and
    ``wd`` replicate, so every contraction runs whole on one device and
    serving stays bit-identical at any tp (the reference's deterministic
    TP; its partial-sum all-reduce would change the summation order)."""

    def spec(path, leaf):
        if path and path[-1] in ("wo", "wd"):
            return ()
        return param_spec(path, leaf, cfg, mesh)

    return _map(params, spec)


def spec_summary(cfg: ModelConfig, mesh, params) -> str:
    """One line per param name of the chosen specs, surfacing the silent
    ``param_spec`` fallbacks to replication.  Printed by ``serve.py
    --tp``."""
    msize = _axis_size(mesh, "model")
    lines = [
        f"partition specs over model={msize} "
        f"(fused heads tile cleanly: "
        f"{_heads_tile_cleanly(cfg, msize)}; whole-KV-head serving "
        f"split: {kv_heads_shardable(cfg, msize)}):"
    ]
    seen = {}
    for path, leaf in _leaves(params):
        spec = param_spec(path, leaf, cfg, mesh)
        name = path[-1]
        label = f"{spec}" if any(s is not None for s in spec) else "replicated"
        if name not in seen:
            seen[name] = label
        elif seen[name] != label:
            seen[name] += f" | {label}"
    for name in sorted(seen):
        lines.append(f"  {name:12s} -> {seen[name]}")
    return "\n".join(lines)


# the column leaves the serving steps compute in column slabs, and the
# q/k/v biases, which follow their weight's columns
_SLABBED = {"wq", "wk", "wv", "wg", "wu", "lm_head"}
_BIASES = {"bq", "bk", "bv"}


def _shard_dim(path, leaf, cfg: ModelConfig, mesh) -> int:
    """The dim a leaf is split along over the mesh's shards, or -1 for a
    leaf the controller holds whole: the serving specs' dim, and for a
    q/k/v bias its weight's (the reference replicates the biases; the
    port's shards add their own columns')."""
    name = path[-1]
    if name in _BIASES:
        n = leaf.shape[-1]
        return leaf.ndim - 1 if _fits(n, _axis_size(mesh, "model")) else -1
    if name in ("wo", "wd"):
        return -1
    spec = param_spec(path, leaf, cfg, mesh)
    return spec.index("model") if "model" in spec else -1


def _own(t, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that shares no storage
    with it."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t)


def _slab_major(path, part, slabs: int) -> torch.Tensor:
    """A shard's column leaf (..., K, N) as ``slabs`` contiguous column
    slabs (..., slabs, K, N / slabs); a bias (..., N) as (..., slabs,
    N / slabs).  Every slab of every mesh of one group is then one
    contiguous (K, N / slabs) operand."""
    if slabs == 1:
        return part
    part = part.unflatten(-1, (slabs, part.shape[-1] // slabs))
    if path[-1] not in _BIASES:
        part = part.movedim(-2, -3)
    return part.contiguous()


def placer(cfg: ModelConfig, mesh):
    """``place(path, leaf)``: a leaf's per-shard parts (a tuple, one a
    shard, each on its device) or, for a leaf the controller holds whole,
    that one tensor on the controller.  A split leaf's parts are copies
    (never views of ``leaf``), the column leaves laid out slab-major
    (``_slab_major``) when a shard computes more than one slab.  Used by
    ``shard_params`` and, leaf by leaf as they are drawn, by
    ``models/model.py::init_params(place=)``."""
    tp = _axis_size(mesh, "model")
    per = mesh.slabs // tp
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"tensor parallelism serves the dense family and the VLM text "
            f"backbone; {cfg.name} ({cfg.family}) under TP is not ported "
            f"yet (ROADMAP.md Queue A)"
        )
    if not kv_heads_shardable(cfg, mesh.slabs):
        raise ValueError(
            f"a column-slab group of {mesh.slabs} would split a head of "
            f"{cfg.name} ({cfg.n_heads} query / {cfg.n_kv_heads} KV heads)"
        )

    def place(path, leaf):
        d = _shard_dim(path, leaf, cfg, mesh)
        if d < 0:
            return leaf.to(mesh.controller)
        name = path[-1]
        col = name in _SLABBED or name in _BIASES
        if col and leaf.shape[d] % mesh.slabs:
            raise ValueError(
                f"{'/'.join(path)}: width {leaf.shape[d]} does not split "
                f"into {mesh.slabs} column slabs"
            )
        return tuple(
            _slab_major(path, _own(part, dev), per if col else 1)
            for part, dev in zip(leaf.chunk(tp, d), mesh.devices)
        )

    return place


def split_shards(tree, tp: int) -> list:
    """A tree of placed leaves (``placer``) as one param tree per shard: a
    split leaf's part i in shard i's, a whole leaf shared by all."""

    def pick(i):
        return _map(tree, lambda _, leaf: leaf[i] if isinstance(leaf, tuple) else leaf)

    return [pick(i) for i in range(tp)]


def trivial(mesh) -> bool:
    """A one-device mesh of one column slab: the unsharded serve."""
    return mesh is None or (_axis_size(mesh, "model") == 1 and mesh.slabs == 1)


def shard_params(params, cfg: ModelConfig, mesh) -> list:
    """One param tree per shard of ``mesh`` (``placer``): a split leaf's
    chunk along its dim, copied to the shard's device, a whole leaf the
    controller's one copy, shared by every shard.  A trivial mesh gives
    ``[params]`` itself."""
    if trivial(mesh):
        return [params]
    return split_shards(_map(params, placer(cfg, mesh)), _axis_size(mesh, "model"))


def card_bytes(cfg: ModelConfig, tp: int) -> int:
    """The most bytes of weights the first card of a ``tp``-card mesh
    holds while ``init_params(place=placer)`` draws and splits the tree
    there, leaf by leaf in draw order: its share of every leaf placed so
    far (a split leaf's 1/tp, a whole leaf all of it), plus the leaf in
    flight, whole in its dtype with its f32 draw and that draw's scaled
    copy (one layer's of a stack drawn layer by layer).  At tp 1, the
    tree's bytes.  Counts shapes only (``init_params`` on the meta
    device)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.model import draws_by_layer, init_params

    tree = init_params(cfg, 0, device="meta")
    if tp == 1:
        return sum(leaf.numel() * leaf.element_size() for _, leaf in _leaves(tree))
    mesh = make_serving_mesh(tp, device="cpu")
    by_layer = draws_by_layer(cfg)
    held = most = 0
    for path, leaf in _leaves(tree):
        n = leaf.numel() * leaf.element_size()
        if path[-1].startswith(("ln", "b", "final")):
            drawn = 0  # zeros, allocated in their dtype
        else:
            layers = cfg.n_layers if by_layer and path[0] == "blocks" else 1
            drawn = 8 * leaf.numel() // layers
        most = max(most, held + n + drawn)
        held += n // tp if _shard_dim(path, leaf, cfg, mesh) >= 0 else n
    return max(most, held)
