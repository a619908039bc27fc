"""Partition rules of tensor parallelism (counterpart of
``repro.launch.sharding``).

Megatron-style tensor parallelism over the ``model`` axis:
  column-parallel: wq/wk/wv (fused head dim), wg/wu (d_ff), router,
                   lm_head, and the embedding's vocab dim
  row-parallel:    wo, wd (contracting dim), which serving replicates
                   (``serving_param_shardings``)
  expert-parallel: the MoE expert stacks shard their expert dim over
                   ``model`` when it divides, else fall back to d_ff
Optimizer moments additionally shard one more dim over the data axes
(ZeRO-1, ``opt_spec``).  Every rule checks divisibility and falls back to
replication.

A spec is a tuple naming, for each dim of a leaf, ``"model"`` (sharded
over the model axis), a data-axis name, or ``None``, as a JAX
``PartitionSpec`` does; ``()`` replicates.  The ``*_shardings`` functions
return trees of specs (the reference's ``NamedSharding`` less the mesh).

Serving placement (the port's choice): the residual stream and the
replicated products (norms, wo, wd, RoPE and every elementwise op) run
once, on the mesh's first device (its controller); the column products
and the paged attention run on each shard's device.  So the replicated
leaves live on the controller only, and every shard's tree refers to that
one copy; a split leaf's parts are copies, and the column leaves are laid
out slab-major when a shard computes more than one slab of the mesh's
group (``placer``).  The MoE leaves take the reference's serving rules at
the group's size G: the router splits along E when G divides it, the
expert ``wg``/``wu`` along E (whole experts a shard) when G divides E and
else along d_ff in slabs, and the expert ``wd`` stays whole on the
controller, so every mesh of one group computes the same products.

Training placement (``place_train``): ``param_shardings``' specs, so
``wo``/``wd`` (and the expert ``wd``) keep Megatron row parallelism; each
data replica holds its own copy of the tree, a split leaf as its model
shards on the replica's devices, a replicated leaf once on the replica's
controller.  ``gather_train`` turns it back into one tree.  Every family
trains on a mesh; serving under a mesh (``placer``) takes the attention
families only, as the reference's ``serve.py`` sends the recurrent and
audio families to its sequential engine without ``--tp``.

The compile analysis's layout options (the reference's ``--opt`` flags,
module globals there) are an explicit ``Options`` here, threaded with the
mesh.  ``attn_fallback`` is the reference's ``ATTN_REPLICATE_IF_RAGGED``:
where the heads do not tile the model axis, the attention weights split
over the data axes instead (``param_spec``), each replica holding its
slice on its controller (``place_train``) and every layer gathering the
slices (``models/model.py::_Replica``); their moments take the slice's
shape.  The reference's ``opt_spec`` would add the data axes to such a
moment a second time, which ``NamedSharding`` refuses.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.launch.mesh import DeviceMesh, data_axes
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
_ATTN = {"wq", "wk", "wv", "wo"}


@dataclasses.dataclass(frozen=True)
class Options:
    """The compile analysis's layout options (``launch/dryrun.py --opt``):

    seq_par        ``seq-par``: the prefill's attention in query chunks of
                   ``layers.SEQPAR_CHUNK`` dealt round-robin over the model
                   axis (``layers.flash_attention_seqpar``)
    flat_gqa       ``flat-gqa``: K/V repeated to every query head before
                   attention (the kernel at R 1)
    attn_fallback  ``attn-fallback``: attention weights split over the data
                   axes where the heads do not tile the model axis
    """
    seq_par: bool = False
    flat_gqa: bool = False
    attn_fallback: bool = False


NO_OPTIONS = Options()


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


def param_spec(path: Tuple[str, ...], leaf, cfg: ModelConfig, mesh,
               fallback: bool = False) -> tuple:
    """The spec of the leaf at ``path`` (its keys from the tree's root):
    the reference's ``param_spec`` rules, as a tuple.  ``fallback``: the
    ragged-heads rule (``Options.attn_fallback``)."""
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

    if (fallback and name in _ATTN and cfg.family != "ssm"
            and not _heads_tile_cleanly(cfg, msize)):
        # ragged heads: the attention weights split over the data axes
        _, dsize, ax = _data_size(mesh)
        d = ndim - 1 if name != "wo" else ndim - 2
        if _fits(leaf.shape[d], dsize):
            spec[d] = ax
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
    """``fn(path, leaf)`` over a nested dict's leaves (a placed leaf's
    tuple of parts is one leaf)."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out[key] = _map(node, fn, path + (key,))
        else:
            out[key] = fn(path + (key,), node)
    return out


def _map_nested(tree, fn, path=()):
    """``fn(path, leaf)`` over the tensors of nested dicts, tuples and
    lists (a tuple's element keyed by its index, as ``str``); None stays
    None, as in a JAX tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_nested(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_nested(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


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


def spec_summary(cfg: ModelConfig, mesh, params,
                 fallback: bool = False) -> str:
    """One line per param name of the chosen specs, surfacing the silent
    ``param_spec`` fallbacks to replication.  Printed by ``serve.py
    --tp`` and by the compile analysis (``fallback``: the ragged-heads
    rule)."""
    msize = _axis_size(mesh, "model")
    lines = [
        f"partition specs over model={msize} "
        f"(fused heads tile cleanly: "
        f"{_heads_tile_cleanly(cfg, msize)}; whole-KV-head serving "
        f"split: {kv_heads_shardable(cfg, msize)}):"
    ]
    seen = {}
    for path, leaf in _leaves(params):
        spec = param_spec(path, leaf, cfg, mesh, fallback)
        name = path[-1]
        label = f"{spec}" if any(s is not None for s in spec) else "replicated"
        if name not in seen:
            seen[name] = label
        elif seen[name] != label:
            seen[name] += f" | {label}"
    for name in sorted(seen):
        lines.append(f"  {name:12s} -> {seen[name]}")
    if cfg.moe_experts:
        E, F = cfg.moe_experts, cfg.d_ff
        rule = {
            "experts": f"expert-parallel, {E // msize} of {E} experts a shard",
            "ffn": f"d_ff-parallel ({E} experts do not split over "
                   f"{msize}), {F // msize} of {F} columns a shard",
            "replicated": "replicated",
        }[expert_rule(cfg, msize)]
        lines.append(f"  expert rule  -> {rule}; serving keeps the expert "
                     f"wd whole")
    return "\n".join(lines)


# the column leaves the serving steps compute in column slabs, and the
# q/k/v biases, which follow their weight's columns
_SLABBED = {"wq", "wk", "wv", "wg", "wu", "lm_head", "router"}
_BIASES = {"bq", "bk", "bv"}


def _is_expert(path, cfg: ModelConfig) -> bool:
    return (cfg.moe_experts > 0 and path[-1] in ("wg", "wu", "wd")
            and "blocks" in path)


def expert_rule(cfg: ModelConfig, size: int) -> str:
    """How ``param_spec`` splits the expert stacks over a model axis of
    ``size``: ``"experts"`` (along E), ``"ffn"`` (along d_ff) or
    ``"replicated"``."""
    if _fits(cfg.moe_experts, size):
        return "experts"
    return "ffn" if _fits(cfg.d_ff, size) else "replicated"


def router_split(cfg: ModelConfig, size: int) -> bool:
    """Whether ``param_spec`` splits the router's E columns over ``size``."""
    return _fits(cfg.moe_experts, size)


def _shard_dim(path, leaf, cfg: ModelConfig, mesh) -> int:
    """The dim a leaf is split along over the mesh's shards, or -1 for a
    leaf the controller holds whole: the serving specs' dim, and for a
    q/k/v bias its weight's (the reference replicates the biases; the
    port's shards add their own columns').  The router and the expert
    stacks take their rule at the mesh's column-slab group (the
    reference's at tp, which is the group unless one is given), so every
    mesh of one group splits them alike."""
    name = path[-1]
    if name in _BIASES:
        n = leaf.shape[-1]
        return leaf.ndim - 1 if _fits(n, _axis_size(mesh, "model")) else -1
    if name in ("wo", "wd"):
        return -1
    if name == "router":
        return leaf.ndim - 1 if router_split(cfg, mesh.slabs) else -1
    if _is_expert(path, cfg):
        rule = expert_rule(cfg, mesh.slabs)
        if rule == "experts":
            return leaf.ndim - 3
        return leaf.ndim - 1 if rule == "ffn" else -1
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


def _slab_major_experts(part, slabs: int) -> torch.Tensor:
    """A shard's d_ff columns of an expert stack (..., E, D, F / tp) as
    ``slabs`` slabs ahead of the experts, (..., slabs, E, D, F / G): slab
    j of every expert is then one contiguous (E, D, F / G) operand (a
    batched product's) and of expert e one contiguous (D, F / G)."""
    if slabs == 1:
        return part
    part = part.unflatten(-1, (slabs, part.shape[-1] // slabs))
    return part.movedim(-2, -4).contiguous()


def placer(cfg: ModelConfig, mesh):
    """``place(path, leaf)``: a leaf's per-shard parts (a tuple, one a
    shard, each on its device) or, for a leaf the controller holds whole,
    that one tensor on the controller.  A split leaf's parts are copies
    (never views of ``leaf``), the column leaves laid out slab-major
    (``_slab_major``) when a shard computes more than one slab.  Used by
    ``shard_params`` and, leaf by leaf as they are drawn, by
    ``models/model.py::init_params(place=)``.  An expert stack split along
    E keeps whole experts (no slabs); along d_ff its slabs come ahead of
    the experts (``_slab_major_experts``)."""
    tp = _axis_size(mesh, "model")
    per = mesh.slabs // tp
    check_mesh_family(cfg)
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
        if _is_expert(path, cfg):
            parts = leaf.chunk(tp, d)
            if d == leaf.ndim - 3:          # whole experts a shard
                return tuple(_own(p, dev) for p, dev in zip(parts, mesh.devices))
            return tuple(_slab_major_experts(_own(p, dev), per)
                         for p, dev in zip(parts, mesh.devices))
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


def check_mesh_family(cfg: ModelConfig) -> None:
    """Tensor-parallel serving runs the attention families (dense, MoE and
    the VLM's text backbone); the reference's ``serve.py`` serves the
    recurrent and audio families through its sequential engine, without
    ``--tp``.  Training takes every family on a mesh (``place_train``)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"tensor-parallel serving runs the dense, MoE and VLM families; "
            f"{cfg.name} ({cfg.family}) under a mesh is not ported for "
            f"serving: the reference serves it through its sequential "
            f"engine, without --tp"
        )


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
    copy (one layer's of a stack drawn layer by layer, one (layer,
    expert) slice's of an expert stack).  At tp 1, the
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
            slices = 1                # f32 draws made at once
            if _is_expert(path, cfg):
                slices = leaf.shape[0] * leaf.shape[1]
            elif by_layer and path[0] == "blocks":
                slices = cfg.n_layers
            drawn = 8 * leaf.numel() // slices
        most = max(most, held + n + drawn)
        held += n // tp if _shard_dim(path, leaf, cfg, mesh) >= 0 else n
    return max(most, held)


# ---------------------------------------------------------------------------
# the training half: params, optimizer state, inputs and decode caches
# ---------------------------------------------------------------------------


def _data_size(mesh) -> Tuple[tuple, int, Any]:
    """(data axes, their total size, the spec entry naming them)."""
    daxes = data_axes(mesh)
    dsize = math.prod(_axis_size(mesh, a) for a in daxes)
    return daxes, dsize, (daxes if len(daxes) > 1 else daxes[0])


def tree_shardings(tree, spec_fn, mesh):
    """``spec_fn(path, leaf)`` over every tensor of ``tree`` (nested dicts,
    tuples and lists): the tree of specs."""
    return _map_nested(tree, spec_fn)


def param_shardings(cfg: ModelConfig, params, mesh):
    """``param_spec`` of every leaf: the training layout, which keeps
    Megatron row parallelism of ``wo``/``wd``."""
    return tree_shardings(params, lambda p, l: param_spec(p, l, cfg, mesh),
                          mesh)


def opt_spec(pspec: tuple, leaf, mesh) -> tuple:
    """ZeRO-1: a moment takes its param's spec plus the first free dim that
    the data axes divide, over them; a param the data axes split already
    (the ragged-heads rule) gives its moment its own spec."""
    _, dsize, ax = _data_size(mesh)
    spec = list(pspec) + [None] * (leaf.ndim - len(pspec))
    if ax in spec:
        return tuple(spec)
    for d in range(leaf.ndim):
        if spec[d] is None and _fits(leaf.shape[d], dsize):
            spec[d] = ax
            break
    return tuple(spec)


def opt_shardings(cfg: ModelConfig, params, opt_state, mesh):
    """The specs of an ``AdamWState(step, m, v)``: the step replicated, each
    moment ``opt_spec`` of its param's spec."""
    def m_spec(path, leaf):
        return opt_spec(param_spec(path, leaf, cfg, mesh), leaf, mesh)

    return type(opt_state)(step=(),
                           m=tree_shardings(opt_state.m, m_spec, mesh),
                           v=tree_shardings(opt_state.v, m_spec, mesh))


def batch_spec(cfg: ModelConfig, batch: int, mesh) -> Tuple[Any, int]:
    """(the batch dim's spec entry, the data axes' size): the data axes
    when they divide ``batch``, else None (replicated)."""
    _, dsize, ax = _data_size(mesh)
    return (ax if _fits(batch, dsize) else None), dsize


def input_shardings(cfg: ModelConfig, inputs, mesh):
    """Every input's leading (batch) dim over the data axes when they
    divide it; scalars replicated."""
    def spec(path, leaf):
        if leaf.ndim == 0:
            return ()
        bax, _ = batch_spec(cfg, leaf.shape[0], mesh)
        return (bax,) + (None,) * (leaf.ndim - 1)

    return tree_shardings(inputs, spec, mesh)


def cache_shardings(cfg: ModelConfig, cache, mesh, batch: int):
    """Decode-cache specs.  KV (L, B, S, KV, hd): the batch over the data
    axes when they divide it, else the sequence (distributed-context
    decode); hd over model.  Hymba's ssm (L, B, H, hd, N): batch over data,
    hd over model.  xLSTM states: the batch dim over data, then the largest
    remaining dim of at least 4 x model over model."""
    _, dsize, ax = _data_size(mesh)
    msize = _axis_size(mesh, "model")
    batch_ok = _fits(batch, dsize)

    def spec(path, leaf):
        name = path[-1] if path else ""
        nd = leaf.ndim
        s = [None] * nd
        if name in ("k", "v"):
            if batch_ok:
                s[1] = ax
            elif _fits(leaf.shape[2], dsize):
                s[2] = ax
            if _fits(leaf.shape[4], msize):
                s[4] = "model"
            return tuple(s)
        if name == "ssm":
            if batch_ok:
                s[1] = ax
            if _fits(leaf.shape[3], msize):
                s[3] = "model"
            return tuple(s)
        for d in range(nd):
            if batch_ok and leaf.shape[d] == batch and s[d] is None:
                s[d] = ax
                break
        for d in sorted(range(nd), key=lambda d: -leaf.shape[d]):
            if (s[d] is None and _fits(leaf.shape[d], msize)
                    and leaf.shape[d] >= 4 * msize):
                s[d] = "model"
                break
        return tuple(s)

    return tree_shardings(cache, spec, mesh)


class CacheLayout(NamedTuple):
    """Where a dense decode cache's K and V (L, B, S, KV, hd) lie
    (``cache_layout``): ``rows`` the batch rows one data replica's cache
    holds, ``seq_parts`` the data replicas its sequence splits over (1:
    none), ``model`` its split over the model axis: ``"heads"`` (whole KV
    heads a shard), ``"hd"`` (an hd slice a shard) or ``"none"`` (whole on
    the controller)."""
    rows: int
    seq_parts: int
    model: str


def cache_layout(cfg: ModelConfig, mesh, batch: int,
                 max_len: int) -> CacheLayout:
    """The decode cache's layout that ``models/model.py``'s
    ``replica_decode_cache``, ``replica_prefill`` and
    ``replica_decode_step`` place and read, for a global ``batch``.

    Over a ``DeviceMesh`` it is ``cache_shardings``' spec of the K/V leaf:
    the batch over the data axes when they divide it (each replica its
    rows), else the sequence over them when they divide it
    (distributed-context decode), else neither (the reference replicates
    the cache over data; the port keeps it on replica 0); hd over model.
    One substitution: KV heads that split whole over the model axis
    (``kv_heads_shardable``) lie by whole heads, which holds the same
    bytes a card as hd over model and needs no reduce of scores (each
    shard attends on its own heads).  A ``ServingMesh`` (one serving
    replica's row) keeps the paged pool's rule (``pool_kv_spec``): whole
    KV heads a shard, else the whole cache on the controller."""
    tp = 1 if mesh is None else _axis_size(mesh, "model")
    heads = tp > 1 and kv_heads_shardable(cfg, tp)
    if not isinstance(mesh, DeviceMesh):
        return CacheLayout(batch, 1, "heads" if heads else "none")
    leaf = torch.empty((cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                        cfg.hd), device="meta")
    spec = cache_shardings(cfg, {"k": leaf}, mesh, batch)["k"]
    _, dsize, ax = _data_size(mesh)
    model = ("heads" if heads else
             "hd" if tp > 1 and spec[4] == "model" else "none")
    return CacheLayout(batch // dsize if spec[1] == ax else batch,
                       dsize if spec[2] == ax else 1, model)


class StateLayout(NamedTuple):
    """Where a decode cache's recurrent state lies (``state_layout``):
    ``rows`` the batch rows replica 0's state holds, ``dims`` the dim
    each leaf splits over the model axis (-1: whole on the controller),
    by the leaf's path in the state tree as ``tree_shardings`` keys it:
    ``("ssm",)``, or ``("mlstm", "0")`` .. ``("slstm", "3")``."""
    rows: int
    dims: Dict[tuple, int]


# each state leaf's batch dim and the dim the decode steps it on when it
# splits over model, both from the end: Hymba's ssm (L, B, H, hd, N) on hd;
# mLSTM's C (.., B, H, hd, hd) on its rows (C[i, j] = v_i k_j), n (.., B,
# H, hd) on hd, the conv buffer (.., B, K - 1, Dp) on Dp, m (.., B, H)
# never; sLSTM's c, n, h, m (.., B, H, hd) on hd
_STATE_DIMS = {("ssm",): (-4, -2),
               ("mlstm", "0"): (-4, -2), ("mlstm", "1"): (-3, -1),
               ("mlstm", "2"): (-2, None), ("mlstm", "3"): (-3, -1),
               **{("slstm", str(i)): (-3, -1) for i in range(4)}}


def state_layout(cfg: ModelConfig, mesh, batch: int) -> StateLayout:
    """The recurrent state's layout that ``models/model.py``'s
    ``replica_decode_cache``, ``replica_prefill`` and
    ``replica_decode_step`` place and step, for a global ``batch``.

    Over a ``DeviceMesh`` it is ``cache_shardings``' spec of each leaf:
    the batch over the data axes when they divide it (each replica its
    rows); Hymba's ssm hd over model; an xLSTM leaf's largest dim that
    divides and is at least 4 x model over model (mLSTM's per-head m stays
    whole).  A model axis of 1, a ``ServingMesh`` and no mesh keep every
    leaf whole on the controller.  The step splits a leaf on the dim of
    ``_STATE_DIMS`` only, so a spec that puts the data axes (over 1) off
    the batch dim, or the model axis on another dim, is refused."""
    from repro_torch.models.model import init_decode_cache
    cache = init_decode_cache(cfg, batch, 0, device="meta")
    tree = ({"ssm": cache["ssm"]} if cfg.family == "hybrid" else
            cache if cfg.family == "ssm" else {})
    leaves = []
    _map_nested(tree, lambda p, t: leaves.append((p, t)))
    tp = 1 if mesh is None else _axis_size(mesh, "model")
    if not isinstance(mesh, DeviceMesh):
        return StateLayout(batch, {p: -1 for p, _ in leaves})
    _, dsize, ax = _data_size(mesh)
    rows, dims = batch, {}
    for path, leaf in leaves:
        spec = cache_shardings(cfg, {path[-1]: leaf}, mesh,
                               batch)[path[-1]]
        bdim, mdim = (d if d is None else d % leaf.ndim
                      for d in _STATE_DIMS[path])
        if dsize > 1 and ax in spec:
            if spec.index(ax) != bdim:
                raise ValueError(
                    f"{cfg.name}: cache_shardings puts the data axes on dim "
                    f"{spec.index(ax)} of the state leaf {path} "
                    f"{tuple(leaf.shape)}, not on its batch dim {bdim} (a "
                    f"lead dim equals the batch {batch}); the decode steps "
                    f"a replica's batch rows")
            rows = batch // dsize
        split = spec.index("model") if "model" in spec and tp > 1 else -1
        if split not in (-1, mdim):
            raise ValueError(
                f"{cfg.name}: cache_shardings splits dim {split} of the "
                f"state leaf {path} {tuple(leaf.shape)} over model; the "
                f"decode steps it split on dim {mdim} only")
        dims[path] = split
    return StateLayout(rows, dims)


def place_state(state, lay: StateLayout, devices) -> Any:
    """A whole recurrent state (a dict of leaves or of tuples of leaves,
    keyed as ``state_layout`` keys them) in ``lay``: each leaf split over
    model as a tuple of its parts, part j a copy on ``devices[j]``; the
    others as they are."""
    def place(path, t):
        d = lay.dims[path]
        if d < 0:
            return t
        return tuple(_own(part, dev)
                     for part, dev in zip(t.chunk(len(devices), d), devices))

    return _map_nested(state, place)


@functools.lru_cache(maxsize=None)
def _logical_tree(cfg: ModelConfig):
    from repro_torch.models.model import init_params
    return dict(_leaves(init_params(cfg, 0, device="meta")))


class Dims(NamedTuple):
    """A leaf's training layout: the dim ``param_spec`` splits over the
    model axis, the dim the data axes split (its moments', or with
    ``data_split`` the param's own), each -1 for none."""
    model: int
    data: int
    data_split: bool = False


def train_dims(cfg: ModelConfig, mesh,
               opts: Options = NO_OPTIONS) -> Dict[tuple, Dims]:
    """Each leaf's ``Dims`` in the training layout, by path."""
    _, _, ax = _data_size(mesh)
    out = {}
    for path, leaf in _logical_tree(cfg).items():
        ps = param_spec(path, leaf, cfg, mesh, opts.attn_fallback)
        os_ = opt_spec(ps, leaf, mesh)
        md = ps.index("model") if "model" in ps else -1
        dd = next((i for i, a in enumerate(os_)
                   if a is not None and a != "model"), -1)
        out[path] = Dims(md, dd, ax in ps)
    return out


def place_train(params, cfg: ModelConfig, mesh,
                opts: Options = NO_OPTIONS) -> list:
    """The training layout over ``mesh`` (a ``DeviceMesh``, or a
    ``ServingMesh`` as one data replica): one placed tree per data
    replica, each its own copies.  A leaf ``param_spec`` splits over model
    is a tuple of its model shards, shard ``m`` on the replica's device
    ``m``; a replicated leaf is one tensor on the replica's controller; a
    leaf the data axes split (``Options.attn_fallback``) is the replica's
    slice of it, on its controller.  At a model axis of 1 every leaf is
    whole."""
    dims = train_dims(cfg, mesh, opts)
    tp = _axis_size(mesh, "model")
    n = mesh.n_replicas
    out = []
    for d in range(n):
        row = mesh.replica(d)

        def place(path, leaf):
            md, dd, split = dims[path]
            if split:
                return _own(leaf.chunk(n, dd)[d], row.controller)
            if md < 0 or tp == 1:
                return _own(leaf, row.controller)
            return tuple(_own(part, dev)
                         for part, dev in zip(leaf.chunk(tp, md), row.devices))

        out.append(_map(params, place))
    return out


def gather_train(placed, cfg: ModelConfig, mesh, device="cpu",
                 opts: Options = NO_OPTIONS):
    """One whole tree on ``device`` from ``place_train``'s list (or one
    data replica's placed tree, when no leaf is split over the data
    axes): each split leaf's shards concatenated along its model dim, a
    data-split leaf's slices along its data dim."""
    reps = placed if isinstance(placed, list) else [placed]
    dims = train_dims(cfg, mesh, opts)

    def whole(path, leaf):
        md, dd, split = dims[path]
        if split:
            if len(reps) != mesh.n_replicas:
                raise ValueError(f"{'/'.join(path)} is split over the data "
                                 f"axes: pass every replica's tree")
            return torch.cat([leaf_at(r, path).to(device) for r in reps], dd)
        if isinstance(leaf, tuple):
            return torch.cat([p.to(device) for p in leaf], md)
        return leaf.to(device)

    return _map(reps[0], whole)


def leaf_at(tree, path):
    """The leaf of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def layout_notes(cfg: ModelConfig, mesh, opts: Options = NO_OPTIONS) -> list:
    """Where the port's layout departs from the reference's specs (the
    compile analysis prints them beside the specs): the training and
    prefill attention runs on whole heads, so heads that do not tile the
    model axis are gathered and attend on the controller (the reference
    sets no spec there and leaves the layout to GSPMD); the prefill's and
    the training forward's recurrent scans run on the controller.  The
    decode cache follows ``cache_layout`` and ``state_layout``."""
    tp = _axis_size(mesh, "model")
    out = []
    if cfg.family != "ssm":
        if kv_heads_shardable(cfg, tp):
            out.append(f"attention on whole heads: {cfg.n_heads // tp} query "
                       f"/ {cfg.n_kv_heads // tp} KV heads a shard, the "
                       f"decode cache by whole KV heads (as many bytes a "
                       f"card as the reference's hd over model)")
        else:
            out.append(f"attention on whole heads: {cfg.n_heads} query / "
                       f"{cfg.n_kv_heads} KV heads do not split over model="
                       f"{tp}, so the training and prefill q, k, v are "
                       f"gathered and attend on each replica's controller "
                       f"(the reference sets no spec for these activations: "
                       f"GSPMD gathers q and k or all-reduces the scores)")
    if cfg.family in ("ssm", "hybrid"):
        out.append("the prefill's and the training forward's recurrent "
                   "scans run on each replica's controller over gathered "
                   "columns; the prefill's final state is then written into "
                   "the decode layout, where each shard steps its part")
    if opts.seq_par:
        out.append("seq-par: the prefill's query chunks dealt round-robin "
                   "over model, each shard through the prefix kernel over "
                   "the whole KV")
    if opts.attn_fallback:
        out.append("attn-fallback: a data-split attention weight's moments "
                   "take its slice's spec (the reference adds the data axes "
                   "a second time)")
    return out
