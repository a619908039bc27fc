"""Dense decoder model and its serving steps (counterpart of the parts of
``repro.models.model`` that the serving engines run).

Params are a plain dict of tensors in ``cfg.tdtype``, with the per-layer
weights stacked on a leading layer axis under ``params["blocks"]``, the
same tree as the JAX package's (``params_from_numpy`` loads that tree from
its flat checkpoint).  Every step runs eagerly, layer by layer:

  prefill            dense [cached prefix ‖ new] prefill (prefix-attention
                     kernel); returns the full-sequence cache
  decode_step        one token over a dense cache, written in place
  paged_prefill_step / paged_decode_step
                     straight against the paged pool, whose new K/V they
                     write IN PLACE before attention
  forward_hidden / forward
                     the training forward over whole sequences, each
                     layer under ``torch.utils.checkpoint`` with
                     ``remat``; its attention is differentiable
                     (``layers.flash_attention``)

Every family of the JAX package is ported: dense (GQA or MHA, an optional
QKV bias, optional sliding windows), MoE (the dense block with a routed
expert FFN, ``moe_impl`` dense or capacity), VLM (the dense block behind an
optional projected patch-embedding prefix, which only ``prefill`` takes:
the runtimes serve the text backbone), audio (the dense block over the sum
of K codebook embeddings of tokens (B, K, S), logits (B, S, K, V)), and
the two recurrent families, which only ``prefill`` and ``decode_step``
run:

  ssm     xLSTM: periods of ``slstm_every - 1`` mLSTM blocks and one sLSTM
          block.  Its cache is the recurrent state, {"mlstm": (C, n, m,
          conv), "slstm": (c, n, h, m)}, each stacked over (period, block)
          or period as in the reference.
  hybrid  Hymba: the attention block, then (on the updated residual) a
          selective-SSM branch; its cache adds "ssm" (L, B, H, hd, N) f32.

Tensor parallelism (the serving steps' ``mesh=``, a
``launch/mesh.py::ServingMesh``; the reference's deterministic TP).
Without a mesh a step runs on a one-shard mesh of its params' device.
``params`` is then ``launch/sharding.py::shard_params``'s list of per-shard
trees (or, on a trivial mesh, the tree), and the paged steps' pool one
plane per shard.  Each shard computes its columns of wq/wk/wv (and their
bias columns), wg/wu and the logits on its device, each product in its
``mesh.slabs / tp`` column slabs (``layers.col_proj``), and the paged
attention of its H/tp query heads over its KV/tp pool heads
(``ops.paged_*_attention(..., mesh=)``); the embedding lookup takes each
token's row from the one shard holding it.  Everything else (the residual
stream, norms, RoPE, the elementwise ops, and the replicated wo/wd through
``layers.dense_rowsum``) runs on the mesh's first device on the gathered,
whole tensors, so every op there sees the shapes a one-device mesh gives
it.  So every mesh of one column-slab group gives the same bits.  The
dense steps keep their cache and attention on the first device too.  The
MoE family's router columns and expert gate/up products run on the shards
that hold them (``_moe_shards``), its down products and combine on the
first device.  The recurrent and audio families serve on trivial meshes
only, as the reference's ``serve.py`` serves them.

The training forward (``forward_hidden``/``forward``/``lm_logits``) runs
one data replica's params over its mesh (``_Replica``), every family:
with ``mesh=``, the training layout (``launch/sharding.py::place_train``):
column products per shard, row products (wo, wd, the expert wd, xLSTM's
w_down, Hymba's ssm_out) per shard with their partial sums added on the
replica's controller, attention per shard on whole heads (gathered onto
the controller when the heads do not tile the model axis), a fused
column output (xLSTM's [x ‖ z]) gathered before it is split, and the
recurrent scans on the controller; without one, the whole tree as a
one-shard replica.  ``training/train_lib.py::make_train_step(mesh=)``
runs it on each data replica.  ``replica_prefill`` / ``replica_decode_step``
run the reference's prefill and decode step in that layout (the compile
analysis's), with the layout options of ``launch/sharding.py::Options``;
over a ``DeviceMesh`` their dense cache lies as the reference's
``cache_shardings`` lays it (``launch/sharding.py::cache_layout``: hd
over model, and a batch the data axes do not divide splits the sequence
over them, each data replica attending to its slice).

The recurrent steps never write a state tensor they were given: they
build new ones, and replace the cache dict's entries.  The sequential
engine hands one step's state on as the next segment's prefix and keeps
it in the knowledge tree as a document snapshot.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import ServingMesh
from repro_torch.launch.sharding import (NO_OPTIONS, Options,
                                         cache_layout, check_mesh_family,
                                         expert_rule,
                                         kv_heads_shardable, leaf_at,
                                         place_state, router_split,
                                         state_layout, trivial)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
RECURRENT = ("ssm", "hybrid")
# a dense model's layer stacks are drawn one layer at a time when the
# largest of them would take more than this in f32 (init_params)
WHOLE_DRAW_BYTES = 8 * 2**30


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue A); "
            f"the port serves {', '.join(FAMILIES)}")


@dataclasses.dataclass
class _Shards:
    """What a serving step computes with: one param tree per shard of
    ``mesh`` (the first shard's device is the controller, which holds the
    replicated leaves and runs the replicated work)."""
    params: List[Dict[str, Any]]
    mesh: ServingMesh

    @property
    def tp(self) -> int:
        return len(self.params)

    @property
    def devices(self) -> List[torch.device]:
        return list(self.mesh.devices)

    @property
    def slabs(self) -> int:
        """The column slabs of each shard's products."""
        return self.mesh.slabs // self.tp

    def layers(self, li: int) -> List[Dict[str, torch.Tensor]]:
        """Every shard's leaves of layer li."""
        return [_layer(p, li) for p in self.params]

    def gather(self, parts, dim: int) -> torch.Tensor:
        """The shards' parts concatenated along ``dim`` on the
        controller."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([t.to(self.devices[0]) for t in parts], dim=dim)


def _shards(cfg: ModelConfig, params, mesh=None) -> _Shards:
    """The step's shards: ``params`` (a tree, or ``shard_params``'s list)
    over ``mesh``, a one-shard mesh of the params' device when None."""
    if isinstance(params, Mapping):
        if not trivial(mesh):
            raise ValueError("a tensor-parallel mesh takes the per-shard "
                             "trees of launch/sharding.py::shard_params")
        params = [params]
    if mesh is None:
        mesh = ServingMesh((params[0]["embed"].device,))
    if not trivial(mesh):
        check_mesh_family(cfg)
    if len(params) != mesh.shape["model"]:
        raise ValueError(f"mesh of tp {mesh.shape['model']} with "
                         f"{len(params)} param shards")
    return _Shards(list(params), mesh)


def _check_paged(cfg: ModelConfig) -> None:
    if cfg.family in RECURRENT:
        raise ValueError("paged steps require per-token KV; ssm/hybrid "
                         "families use prefill and decode_step")


def draws_by_layer(cfg: ModelConfig) -> bool:
    """Whether ``init_params`` draws the dense layer stacks one layer at a
    time (the largest would pass ``WHOLE_DRAW_BYTES`` drawn whole in
    f32)."""
    return not cfg.moe_experts and 4 * cfg.n_layers * cfg.d_model * max(
        cfg.d_ff, cfg.n_heads * cfg.hd) > WHOLE_DRAW_BYTES


def init_params(cfg: ModelConfig, seed: int, device="cpu", *,
                place=None) -> Dict[str, Any]:
    """Seeded random params (the JAX package's init scheme and tree —
    normal(0, 0.02), output projections scaled by 1/sqrt(2L), zero norms
    and biases — drawn from one ``torch.Generator``).

    Each tensor is drawn whole in f32 and cast, except the expert weights,
    the recurrent families' layer weights and the large dense stacks,
    which are drawn one slice of their leading (layer, expert) or (period,
    block) axes at a time into a tensor allocated in its final dtype, so
    that the transient f32 is one slice (Mixtral-8x7B's whole stacked
    expert tensor would be 45 GB in f32).  The rule for the layer stacks
    (wq, wk, wv, wo, wg, wu, wd) of a model without experts: when the
    largest of them would take more than ``WHOLE_DRAW_BYTES`` (8 GiB)
    drawn whole in f32 (Gemma3-12B's wg takes 11.3 GB, Gemma2-27B's 31.3
    GB, Yi-34B's 35.2 GB, LLaMA2-70B's 75.2 GB, Mistral-7B's 7.5 GB), all
    seven are drawn one layer at a time, each layer's slice from the
    stream in layer order; below it every stack is drawn whole, so the
    streams of every model drawn before the rule are unchanged.  The
    dense families draw from the stream in the order they always have;
    the other families' tensors are drawn where they appear in the tree.
    On the ``meta`` device no value is drawn: the tree's shapes and
    dtypes only.

    ``place(path, leaf)``, for the dense, MoE and VLM families: each leaf
    (a whole layer stack) is handed to it as soon as it is drawn and its
    return value kept instead (``launch/sharding.py::placer`` splits it
    over a mesh), so a tree too large for its first device is never whole
    there: that device holds what it keeps plus one leaf in flight."""
    _check_family(cfg)
    if place is None:
        def place(path, leaf):
            return leaf
    D, F, V, nl = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.tdtype
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    scale = 0.02
    out_scale = scale / (2 * nl) ** 0.5

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def mk(shape, s=scale):
        return (normal(shape) * s).to(dt)

    def mk_slices(shape, s=scale, lead=2, draw=None, dtype=dt):
        # drawn over the ``lead`` leading axes, slice by slice
        w = torch.empty(shape, dtype=dtype, device=device)
        for idx in itertools.product(*map(range, shape[:lead])):
            w[idx] = draw(shape[lead:]) if draw else mk(shape[lead:], s)
        return w

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    K = cfg.n_codebooks
    params: Dict[str, Any] = {
        "embed": place(("embed",), mk((K, V, D) if K else (V, D)))}
    if cfg.family == "vlm":
        params["vision_proj"] = place(("vision_proj",), mk((D, D)))
    params["final_norm"] = place(("final_norm",), zeros((D,)))
    if not cfg.tie_embeddings:
        params["lm_head"] = place(("lm_head",), mk((D, V * max(1, K))))
    if cfg.family == "ssm":
        params["blocks"] = _init_xlstm_blocks(cfg, mk_slices, zeros)
        return params
    stack = mk
    if draws_by_layer(cfg):
        def stack(shape, s=scale):
            return mk_slices(shape, s, lead=1)
    blk: Dict[str, Any] = {}

    def put(name, leaf):
        blk[name] = place(("blocks", name), leaf)

    put("ln1", zeros((nl, D)))
    put("wq", stack((nl, D, H * hd)))
    put("wk", stack((nl, D, KV * hd)))
    put("wv", stack((nl, D, KV * hd)))
    put("wo", stack((nl, H * hd, D), out_scale))
    put("ln2", zeros((nl, D)))
    if cfg.moe_experts:
        E = cfg.moe_experts
        put("router", mk((nl, D, E)))
        put("wg", mk_slices((nl, E, D, F)))
        put("wu", mk_slices((nl, E, D, F)))
        put("wd", mk_slices((nl, E, F, D), out_scale))
    else:
        put("wg", stack((nl, D, F)))
        put("wu", stack((nl, D, F)))
        put("wd", stack((nl, F, D), out_scale))
    if cfg.qkv_bias:
        put("bq", zeros((nl, H * hd)))
        put("bk", zeros((nl, KV * hd)))
        put("bv", zeros((nl, KV * hd)))
    if cfg.family == "hybrid":
        N = cfg.ssm_state
        blk["ssm_ln"] = zeros((nl, D))
        blk["ssm_in"] = mk_slices((nl, D, H * hd), lead=1)
        blk["ssm_dt"] = mk_slices((nl, D, H), lead=1)
        blk["ssm_B"] = mk_slices((nl, D, N), lead=1)
        blk["ssm_C"] = mk_slices((nl, D, N), lead=1)
        # A and D are f32 in the reference
        blk["ssm_A"] = mk_slices((nl, H, hd, N), lead=1,
                                 draw=lambda sh: -torch.exp(normal(sh)),
                                 dtype=torch.float32)
        blk["ssm_D"] = torch.ones((nl, H, hd), device=device)
        blk["ssm_out"] = mk_slices((nl, H * hd, D), out_scale, lead=1)
    params["blocks"] = blk
    return params


def _xlstm_dims(cfg: ModelConfig):
    """(Dp, mLSTM head dim, sLSTM head dim, sLSTM FFN width, leads of the
    mLSTM and sLSTM stacks)."""
    D, H = cfg.d_model, cfg.n_heads
    Dp = int(cfg.proj_factor * D)
    if cfg.slstm_every > 0:
        n_periods = cfg.n_layers // cfg.slstm_every
        m_lead, s_lead = (n_periods, cfg.slstm_every - 1), (n_periods,)
    else:
        m_lead, s_lead = (cfg.n_layers,), (0,)
    return Dp, Dp // H, D // H, max(128, (4 * D // 3) // 128 * 128), \
        m_lead, s_lead


def _init_xlstm_blocks(cfg: ModelConfig, mk_slices, zeros):
    """The xLSTM blocks' params, the reference's tree: "mlstm" stacked over
    (period, block), "slstm" over period."""
    D, H = cfg.d_model, cfg.n_heads
    Dp, _, hd_s, F2, m_lead, s_lead = _xlstm_dims(cfg)
    out_scale = 0.02 / (2 * cfg.n_layers) ** 0.5

    def mk(lead, shape, s=0.02):
        return mk_slices(lead + shape, s, lead=len(lead))

    out = {"mlstm": {
        "ln": zeros(m_lead + (D,)),
        "w_up": mk(m_lead, (D, 2 * Dp)),
        "conv_w": mk(m_lead, (cfg.conv_kernel, Dp)),
        "wq": mk(m_lead, (Dp, Dp)),
        "wk": mk(m_lead, (Dp, Dp)),
        "wv": mk(m_lead, (Dp, Dp)),
        "w_if": mk(m_lead, (Dp, 2 * H)),
        "b_if": zeros(m_lead + (2 * H,)),
        "gn": zeros(m_lead + (Dp,)),
        "w_down": mk(m_lead, (Dp, D), out_scale),
    }}
    if cfg.slstm_every > 0:
        out["slstm"] = {
            "ln": zeros(s_lead + (D,)),
            "w_x": mk(s_lead, (D, 4 * D)),
            "b_x": zeros(s_lead + (4 * D,)),
            "r_w": mk(s_lead, (H, hd_s, 4 * hd_s)),
            "gn": zeros(s_lead + (D,)),
            "ln2": zeros(s_lead + (D,)),
            "wg": mk(s_lead, (D, F2)),
            "wu": mk(s_lead, (D, F2)),
            "wd": mk(s_lead, (F2, D), out_scale),
        }
    return out


def params_from_numpy(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device="cpu") -> Dict[str, Any]:
    """Params from the flat dict that ``repro/training/checkpoint.py::save``
    writes: ``/``-joined keys (``"blocks/wq"``), bf16 stored as f32.  Each
    leaf takes the dtype of the same leaf of the port's own tree for
    ``cfg`` (as the reference's ``checkpoint.restore(path, like)`` does):
    ``cfg.tdtype``, or f32 for Hymba's ``ssm_A``/``ssm_D``.  The cast is
    lossless for values representable in that dtype."""
    like = init_params(cfg, 0, device="meta")
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        if key.startswith("__"):            # checkpoint metadata (__step__)
            continue
        node, ref = out, like
        *parents, leaf = key.split("/")
        for p in parents:
            node, ref = node.setdefault(p, {}), ref[p]
        t = torch.tensor(np.asarray(arr, dtype=np.float32))
        node[leaf] = t.to(device=device, dtype=ref[leaf].dtype)
    return out


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The flat dict ``repro/training/checkpoint.py::save`` writes for this
    tree: ``/``-joined keys, every leaf a numpy array, bf16 (which numpy
    cannot hold) as f32.  ``params_from_numpy`` is its inverse."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, Mapping):
                walk(val, prefix + key + "/")
                continue
            t = val.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[prefix + key] = t.numpy()

    walk(params, "")
    return out


def embed_inputs(cfg: ModelConfig, params, tokens,
                 patch_embeds: torch.Tensor | None = None):
    """(B, S) token ids -> (B, S, D) embeddings; with codebooks, (B, K, S)
    ids -> the sum of the K codebooks' embeddings, in codebook order; for
    the VLM family with ``patch_embeds`` (B, Simg, D), their projection
    through ``vision_proj`` is prepended: (B, Simg + S, D).  ``tokens`` may
    also be the reference's inputs dict, {"tokens", optionally
    "patch_embeds"}."""
    if isinstance(tokens, Mapping):
        patch_embeds = tokens.get("patch_embeds", patch_embeds)
        tokens = tokens["tokens"]
    if cfg.n_codebooks:
        if tokens.dim() != 3:
            raise ValueError(f"codebook models take tokens (B, K, S); got "
                             f"{tuple(tokens.shape)}")
        emb = params["embed"]
        x = torch.zeros(tokens.shape[:1] + tokens.shape[2:]
                        + (cfg.d_model,), dtype=emb.dtype,
                        device=tokens.device)
        for kk in range(cfg.n_codebooks):
            x = x + emb[kk][tokens[:, kk]]
        return x
    x = params["embed"][tokens]
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = L.proj(patch_embeds.to(cfg.tdtype), params["vision_proj"])
        x = torch.cat([pe, x], dim=1)
    return x


def _embed(cfg: ModelConfig, sh: _Shards, tokens) -> torch.Tensor:
    """``embed_inputs`` over the shards: each token's row from the one
    shard whose vocab slice holds it (a select, so exact)."""
    if (not isinstance(tokens, torch.Tensor)
            or sh.params[0]["embed"].shape[-2] == cfg.vocab_size):
        return embed_inputs(cfg, sh.params[0], tokens)
    return _vocab_rows([p["embed"] for p in sh.params], sh.devices, tokens)


def _vocab_rows(parts, devices, tokens) -> torch.Tensor:
    """Each token's embedding row from the one part (a vocab slice, on its
    device) that holds it, on the first device: a select, so exact."""
    x = None
    lo = 0
    for emb, dev in zip(parts, devices):
        n = emb.shape[0]
        local = torch.clamp(tokens - lo, 0, n - 1).to(dev)
        rows = emb[local].to(devices[0])
        mine = ((tokens >= lo) & (tokens < lo + n))[..., None]
        x = rows if x is None else torch.where(mine.to(devices[0]), rows, x)
        lo += n
    return x


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """(..., V) f32 logits of the hidden states ``x`` (the training path's):
    the final norm, then the logits product.  ``mesh``: as for
    ``forward_hidden``."""
    return _logits_seq(cfg, _replica(cfg, params, mesh), x)


def _logit_cols(cfg: ModelConfig, params, x, slabs: int) -> torch.Tensor:
    """One shard's logits columns (its vocab slice, in ``slabs`` slabs;
    the tied embedding's in slabs of its rows)."""
    if cfg.tie_embeddings and cfg.n_codebooks:
        return torch.einsum("bsd,kvd->bskv", x, params["embed"])
    if cfg.tie_embeddings:
        emb = params["embed"]
        if slabs <= 1 or emb.shape[0] % slabs:
            return torch.matmul(x, emb.t())
        return torch.cat([torch.matmul(x, e.t())
                          for e in emb.chunk(slabs)], dim=-1)
    return L.col_proj(x, params["lm_head"], slabs=slabs)


def _logits(cfg: ModelConfig, sh: _Shards, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, sh.params[0]["final_norm"], cfg.norm_eps)
    logits = sh.gather([_logit_cols(cfg, p, x.to(d), sh.slabs)
                        for p, d in zip(sh.params, sh.devices)], dim=-1)
    if cfg.n_codebooks and not cfg.tie_embeddings:
        logits = logits.reshape(x.shape[:2] + (cfg.n_codebooks,
                                               cfg.vocab_size))
    if cfg.final_logit_softcap:
        logits = L.softcap(logits.float(), cfg.final_logit_softcap)
    return logits.float()


def _layer(params, li: int) -> Dict[str, torch.Tensor]:
    return {k: w[li] for k, w in params["blocks"].items()}


def _ffn(cfg: ModelConfig, p, x):
    if cfg.moe_experts:
        moe = L.moe_capacity if cfg.moe_impl == "capacity" else L.moe_dense
        return moe(x, p["router"], p["wg"], p["wu"], p["wd"], cfg.moe_top_k)
    return L.swiglu(x, p["wg"], p["wu"], p["wd"])


def _qkv(cfg: ModelConfig, p, h, slabs: int = 1):
    """q (B, S, ., hd), k, v of ``p``'s columns (a shard's heads, or all),
    each product in ``slabs`` column slabs (``layers.col_proj``)."""
    B, S, _ = h.shape
    hd = cfg.hd
    q = L.col_proj(h, p["wq"], p.get("bq"), slabs).reshape(B, S, -1, hd)
    k = L.col_proj(h, p["wk"], p.get("bk"), slabs).reshape(B, S, -1, hd)
    v = L.col_proj(h, p["wv"], p.get("bv"), slabs).reshape(B, S, -1, hd)
    return q, k, v


def _attn_in(cfg: ModelConfig, sh: _Shards, ps, x):
    """q, k, v (B, S, heads, hd) of one layer (``ps``: every shard's
    leaves of it), the shards' columns gathered along heads on the
    controller."""
    h = L.rms_norm(x, ps[0]["ln1"], cfg.norm_eps)
    parts = [_qkv(cfg, p, h.to(d), sh.slabs)
             for p, d in zip(ps, sh.devices)]
    return tuple(sh.gather([pt[j] for pt in parts], dim=2) for j in range(3))


def _ffn_out(cfg: ModelConfig, sh: _Shards, ps, x):
    """One layer's FFN residual update: x + FFN(norm(x)).  The shards'
    gate and up columns are gathered, so the activation and the
    replicated down product run on the whole tensors."""
    h = L.rms_norm(x, ps[0]["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        if trivial(sh.mesh):
            return x + _ffn(cfg, ps[0], h)
        return x + _moe_shards(cfg, sh, ps, h)
    g, u = (sh.gather([L.col_proj(h.to(d), p[w], slabs=sh.slabs)
                       for p, d in zip(ps, sh.devices)], dim=-1)
            for w in ("wg", "wu"))
    return x + L.dense_rowsum(F.silu(g) * u, ps[0]["wd"])


def _expert_cols(w, e: int, slabs: int):
    """Expert e's d_ff columns of a shard's expert stack split along d_ff:
    (slabs, D, F / G) of a slab-major (slabs, E, D, F / G) stack, else
    (D, F / tp)."""
    return w[:, e] if slabs > 1 else w[e]


def _moe_shards(cfg: ModelConfig, sh: _Shards, ps, h):
    """The MoE FFN of one layer over the shards (``ps``: every shard's
    leaves of it) at h, the normed residual on the controller.  The
    router's columns and the experts' gate and up products run on the
    shards that hold them (``launch/sharding.py::placer``: whole experts a
    shard when the group G divides E, else each shard's d_ff slabs); their
    outputs are gathered, and the activation, the replicated down product
    and the combine run on the controller in ``layers.moe_dense``'s /
    ``moe_capacity``'s order and rounding.  Under ``moe_capacity`` a
    shard's whole experts run in batched products of E / G experts each,
    so every mesh of one group makes the same calls."""
    E, k, G = cfg.moe_experts, cfg.moe_top_k, sh.mesh.slabs
    devs, ctl, tp, per = sh.devices, sh.devices[0], sh.tp, sh.slabs
    rule = expert_rule(cfg, G)
    wd = ps[0]["wd"]

    def routed(xr):
        if router_split(cfg, G):
            logits = sh.gather([L.col_proj(xr.to(d), p["router"], slabs=per)
                                for p, d in zip(ps, devs)], dim=-1)
        else:
            logits = L.proj(xr, ps[0]["router"])
        return L.route_logits(logits, k)

    if cfg.moe_impl == "capacity":
        def experts(xbuf):
            if rule == "experts":
                n, own = E // G, E // tp
                g, u = [], []
                for m, (p, d) in enumerate(zip(ps, devs)):
                    xb = xbuf[m * own:(m + 1) * own].to(d)
                    for j in range(per):
                        grp = slice(j * n, (j + 1) * n)
                        for out, w in ((g, "wg"), (u, "wu")):
                            out.append(torch.einsum("eCd,edf->eCf", xb[grp],
                                                    p[w][grp]))
                g, u = sh.gather(g, dim=0), sh.gather(u, dim=0)
            elif rule == "ffn":
                def cols(w):
                    return sh.gather(
                        [torch.einsum("eCd,edf->eCf", xbuf.to(d),
                                      p[w][j] if per > 1 else p[w])
                         for p, d in zip(ps, devs) for j in range(per)],
                        dim=-1)
                g, u = cols("wg"), cols("wu")
            else:
                return torch.einsum("eCf,efd->eCd", L.glu_buffers(
                    xbuf, ps[0]["wg"], ps[0]["wu"]), wd)
            return torch.einsum("eCf,efd->eCd", F.silu(g) * u, wd)

        return L.moe_capacity_with(h, routed, experts, E, k)

    on = {d: h.to(d) for d in dict.fromkeys(devs)}

    def expert(e):
        if rule == "experts":
            m, j = divmod(e, E // tp)
            p, d = ps[m], devs[m]
            g, u = (L.proj(on[d], p[w][j]).to(ctl) for w in ("wg", "wu"))
        elif rule == "ffn":
            g, u = (sh.gather([L.col_proj(on[d], _expert_cols(p[w], e, per),
                                          slabs=per)
                               for p, d in zip(ps, devs)], dim=-1)
                    for w in ("wg", "wu"))
        else:
            return L.swiglu(h, ps[0]["wg"][e], ps[0]["wu"][e], wd[e])
        return L.proj(F.silu(g) * u, wd[e])

    return L.moe_dense_with(h, routed(h), expert, E)


# ---------------------------------------------------------------------------
# recurrent blocks
# ---------------------------------------------------------------------------

def _mlstm_block(cfg: ModelConfig, rep: "_Replica", p, x, state):
    """state: (C, n, m, conv_buf), each whole or, at decode, a tuple of
    its parts over the replica's shards (``launch/sharding.py::
    state_layout``).  Returns (x_out, new_state) in the same layout.  Over
    a replica's shards (``_Replica``) the column products' parts are
    gathered before the split of ``w_up``'s output into [x ‖ z] and before
    the head reshape, and ``w_down`` sums its row shards' parts."""
    B, S, D = x.shape
    Dp, hd, _, _, _, _ = _xlstm_dims(cfg)
    H = cfg.n_heads
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xp, z = rep.gather(rep.col(p["w_up"], h)).chunk(2, dim=-1)
    if isinstance(state[3], tuple):
        xc, conv_buf = _conv_parts(rep, xp, p["conv_w"], state[3])
    else:
        xc, conv_buf = L.causal_conv1d(xp, p["conv_w"], state[3])
    xc = F.silu(xc)
    qs, ks = rep.col(p["wq"], xc), rep.col(p["wk"], xc)
    v = rep.gather(rep.col(p["wv"], xp)).reshape(B, S, H, hd)
    i_g, f_g = L.proj(xc, p["w_if"], p["b_if"]).chunk(2, dim=-1)
    if isinstance(state[0], tuple):
        hout, (C, n, m) = _mlstm_parts(rep, qs, ks, v, i_g, f_g, state[:3])
    else:
        q = rep.gather(qs).reshape(B, S, H, hd)
        k = rep.gather(ks).reshape(B, S, H, hd)
        scan = L.mlstm_scan if S == 1 else L.mlstm_chunkwise
        hout, (C, n, m) = scan(q, k, v, i_g, f_g, state=state[:3])
    hout = L.rms_norm(hout.reshape(B, S, Dp), p["gn"], cfg.norm_eps)
    hout = hout * F.silu(z)
    return x + rep.row(p["w_down"], [hout]), (C, n, m, conv_buf)


def _conv_parts(rep: "_Replica", xp, w, bufs):
    """``layers.causal_conv1d`` over a conv buffer split along its
    channels (Dp), one part a shard: each shard convolves its channels of
    ``xp`` with its slice of ``w`` over its part, and the outputs are
    gathered along Dp on the controller.  Returns (y, the new parts)."""
    out = [L.causal_conv1d(xm.to(b.device), wm.to(b.device), b)
           for xm, wm, b in zip(xp.chunk(len(bufs), -1),
                                w.chunk(len(bufs), -1), bufs)]
    return rep.gather([y for y, _ in out]), tuple(b for _, b in out)


def _mlstm_parts(rep: "_Replica", qs, ks, v, i_g, f_g, state):
    """``layers.mlstm_scan`` at S == 1 over a state whose C and n split
    over the replica's shards: shard j holds C's rows j (v's slice j) and
    n's slice j; m (per head) lies whole on the controller, which computes
    the gates.  Each shard all-gathers q and k whole from their column
    parts ``qs``/``ks`` (``_Replica.col``'s), takes its slice of v and
    the gates, updates C_j and n_j and computes C_j q and its partial
    n_j . q_j; the partials are added on the controller in shard order
    (the all-reduce), the divisor max(|sum|, floor) goes back, and the
    shards' h slices are gathered along hd.  Returns (h (B, 1, H, hd) in
    v's dtype, (C's parts, n's parts, m))."""
    C, n, m = state
    ctl = rep.controller
    B, _, H, hd = v.shape
    w = hd // len(C)

    def whole(parts, dev):
        return torch.cat([op_analysis.to(t, dev, "all-gather")
                          for t in parts], -1).reshape(B, H, hd).float()

    with L.full_f32():
        vs = v.float()[:, 0]
        i_sc, f_sc, m_new = L.mlstm_gates(i_g.float()[:, 0],
                                          f_g.float()[:, 0], m)
        new, nums, den = [], [], None
        for j, (cj, nj) in enumerate(zip(C, n)):
            dev, sl = cj.device, slice(j * w, (j + 1) * w)
            qd, kd = whole(qs, dev), whole(ks, dev) * hd ** -0.5
            cj, nj = L.mlstm_write(cj, nj, vs[..., sl].to(dev), kd,
                                   kd[..., sl], i_sc.to(dev), f_sc.to(dev))
            nums.append(torch.einsum("bhij,bhj->bhi", cj, qd))
            part = op_analysis.to(torch.einsum("bhj,bhj->bh", nj,
                                               qd[..., sl]), ctl,
                                  "all-reduce")
            den = part if den is None else den + part
            new.append((cj, nj))
        div = L.mlstm_divisor(torch.abs(den), m_new)
        hs = [num / op_analysis.to(div, num.device, "all-reduce")[..., None]
              for num in nums]
    h = rep.gather(hs)[:, None].to(v.dtype)
    return h, (tuple(c for c, _ in new), tuple(x for _, x in new), m_new)


def _slstm_block(cfg: ModelConfig, rep: "_Replica", p, x, state):
    """state: (c, n, h, m), each whole or, at decode, a tuple of its
    parts over the replica's shards (split along hd)."""
    B, S, D = x.shape
    H = cfg.n_heads
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    zifo = rep.gather(rep.col(p["w_x"], h, p["b_x"])).reshape(
        B, S, H, 4 * (D // H))
    if isinstance(state[0], tuple):
        out, new_state = _slstm_parts(rep, zifo, p["r_w"], state)
    else:
        out, new_state = L.slstm_scan(zifo, p["r_w"], state)
    x = x + L.rms_norm(out.reshape(B, S, D), p["gn"], cfg.norm_eps)
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _swiglu_rep(rep, p, h2), new_state


def _slstm_parts(rep: "_Replica", zifo, r_w, state):
    """``layers.slstm_scan`` at S == 1 over a state split along hd over
    the replica's shards: h's parts are gathered on the controller for
    the recurrence (h @ r_w needs each head's whole h), each shard gets
    its hd columns of z, i, f and o and steps its c, n, h, m
    (``layers.slstm_cell``), and the new h parts are gathered for the
    block's output.  Returns (h (B, 1, H, hd) in zifo's dtype, the new
    state's parts)."""
    with L.full_f32():
        rec = torch.einsum("bhi,hio->bho", rep.gather(list(state[2])),
                           r_w.float())
        gates = (zifo.float()[:, 0] + rec).chunk(4, dim=-1)
        w = gates[0].shape[-1] // len(state[0])
        new = []
        for j, (c, n, m) in enumerate(zip(state[0], state[1], state[3])):
            sl = slice(j * w, (j + 1) * w)
            new.append(L.slstm_cell(*(g[..., sl].to(c.device)
                                      for g in gates), c, n, m))
    out = rep.gather([s[2] for s in new])[:, None].to(zifo.dtype)
    return out, tuple(tuple(s[i] for s in new) for i in range(4))


def _swiglu_rep(rep: "_Replica", p, h):
    """``layers.swiglu`` over a replica's shards: gate and up by columns,
    the down product's row shards summed on the controller."""
    gs, us = rep.col(p["wg"], h), rep.col(p["wu"], h)
    return rep.row(p["wd"], [F.silu(g) * u for g, u in zip(gs, us)])


def _xlstm_init_state(cfg: ModelConfig, batch: int, device="cpu"):
    """Fresh stacked xLSTM state: {"mlstm": (C, n, m, conv), "slstm": (c,
    n, h, m) or None}, f32 but the conv buffer (``cfg.tdtype``)."""
    Dp, hd_m, hd_s, _, m_lead, s_lead = _xlstm_dims(cfg)
    H, K = cfg.n_heads, cfg.conv_kernel
    m = (torch.zeros(m_lead + (batch, H, hd_m, hd_m), device=device),
         torch.zeros(m_lead + (batch, H, hd_m), device=device),
         torch.full(m_lead + (batch, H), L.NEG_INF, device=device),
         torch.zeros(m_lead + (batch, K - 1, Dp), dtype=cfg.tdtype,
                     device=device))
    if cfg.slstm_every <= 0:
        return {"mlstm": m, "slstm": None}
    z = torch.zeros(s_lead + (batch, H, hd_s), device=device)
    return {"mlstm": m,
            "slstm": (z, torch.ones_like(z), z.clone(), z.clone())}


def _at(leaf, idx):
    """Layer ``idx`` of a state leaf: whole, or a tuple of its parts."""
    return tuple(t[idx] for t in leaf) if isinstance(leaf, tuple) \
        else leaf[idx]


def _put(leaf, idx, new) -> None:
    """Write layer ``idx``'s new state (whole, or parts as ``leaf``'s)
    into ``leaf`` in place."""
    for dst, t in (zip(leaf, new) if isinstance(leaf, tuple)
                   else [(leaf, new)]):
        dst[idx] = t


def _run_xlstm(cfg: ModelConfig, params, x, state, inplace: bool = False):
    """The xLSTM blocks in order over ``state`` (the full stacked state;
    ``_xlstm_init_state`` for a fresh one, or the decode cache's, whose
    split leaves are tuples of parts: ``replica_decode_cache``).
    ``params``: the whole tree, or a ``_Replica``.  Returns (x,
    new_state): each block's state written into new tensors (``state``
    only read), or with ``inplace`` into ``state`` itself."""
    rep = params if isinstance(params, _Replica) else _solo(params, x.device)
    mblk = rep.tree["blocks"]["mlstm"]
    new = state if inplace else {
        k: None if v is None else tuple(torch.empty_like(t) for t in v)
        for k, v in state.items()}
    lead = new["mlstm"][2].shape[:-2]          # m (.., B, H), never split

    def m_layer(x, idx):
        p = _index(mblk, idx)
        x, st = _mlstm_block(cfg, rep, p, x,
                             tuple(_at(t, idx) for t in state["mlstm"]))
        for dst, t in zip(new["mlstm"], st):
            _put(dst, idx, t)
        return x

    if cfg.slstm_every <= 0:
        for li in range(lead[0]):
            x = m_layer(x, li)
        return x, new
    sblk = rep.tree["blocks"]["slstm"]
    for per in range(lead[0]):
        for j in range(lead[1]):
            x = m_layer(x, (per, j))
        x, st = _slstm_block(cfg, rep, _index(sblk, per), x,
                             tuple(_at(t, per) for t in state["slstm"]))
        for dst, t in zip(new["slstm"], st):
            _put(dst, per, t)
    return x, new


def _ssm_branch_seq(cfg: ModelConfig, p, x, state=None, rep=None):
    """Hymba's SSM heads over the residual ``x``: (out, new_state).
    ``rep``: the replica whose shards hold ``p``'s ``ssm_in`` columns and
    ``ssm_out`` rows (None: ``p`` is whole, on x's device)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    rep = rep or _solo({}, x.device)
    h = L.rms_norm(x, p["ssm_ln"], cfg.norm_eps)
    xin = F.silu(rep.gather(rep.col(p["ssm_in"], h))).reshape(B, S, H, hd)
    delta = F.softplus(L.proj(h, p["ssm_dt"]).float())
    args = (xin, delta, p["ssm_A"], L.proj(h, p["ssm_B"]),
            L.proj(h, p["ssm_C"]), p["ssm_D"])
    if isinstance(state, tuple):
        y, new_state = _ssm_parts(rep, *args, state)
    else:
        y, new_state = L.mamba_scan(*args, state=state)
    return rep.row(p["ssm_out"], [y.reshape(B, S, H * hd)]), new_state


def _ssm_parts(rep: "_Replica", xin, delta, A, Bm, Cm, D, state):
    """``layers.mamba_scan`` over a state split along hd over the
    replica's shards (Hymba's ssm at decode): each shard takes its hd
    slice of ``xin``, A and D and the whole delta, B and C, and steps its
    part; the y slices are gathered along hd on the controller (no
    reduction).  Returns (y, the new parts)."""
    w = xin.shape[-1] // len(state)
    ys, new = [], []
    for j, h in enumerate(state):
        sl = slice(j * w, (j + 1) * w)
        y, st = L.mamba_scan(*(t.to(h.device) for t in (
            xin[..., sl], delta, A[:, sl], Bm, Cm, D[:, sl])), state=h)
        ys.append(y)
        new.append(st)
    return rep.gather(ys), tuple(new)


def _hybrid_ssm_init(cfg: ModelConfig, batch: int, device="cpu"):
    return torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.hd,
                        cfg.ssm_state), device=device)


def forward_hidden(cfg: ModelConfig, params, inputs, *, remat: bool = False,
                   attn_impl: str | None = None, mesh=None,
                   opts: Options = NO_OPTIONS, dispatch=None,
                   replica: int = 0) -> torch.Tensor:
    """Training-path forward over whole sequences from position 0: the
    final hidden states (B, S, D) before the final norm (counterpart of
    ``repro.models.model.forward_hidden``).  ``inputs``: {"tokens" (B, S)
    or (B, K, S), optionally "patch_embeds" (B, Simg, D) for the VLM
    family, prepended as in ``embed_inputs``}.  With ``remat`` each layer
    of an attention family runs under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward); the xLSTM blocks run as in
    ``prefill`` from a fresh state, as the reference's do.

    ``mesh``: one data replica's ``(1, tp)`` mesh, ``params`` then that
    replica's tree of ``launch/sharding.py::place_train`` (the training
    layout; see ``_Replica``); without one, ``params`` is the whole tree on
    one device.  ``opts``: the layout options of ``place_train``.
    ``dispatch``/``replica``: a capacity MoE's dispatch across the mesh's
    data replicas (``CapacityDispatch``) and this replica's index there.
    The hidden states come back on the mesh's controller."""
    _check_family(cfg)
    rep = _replica(cfg, params, mesh, opts, dispatch, replica)
    x = _embed_seq(cfg, rep, inputs)
    if cfg.family == "ssm":
        x, _ = _run_xlstm(cfg, rep, x,
                          _xlstm_init_state(cfg, x.shape[0], x.device))
        return x
    windows = cfg.layer_windows()
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for li in range(cfg.n_layers):
        p = _rep_layer(rep, li)
        if remat:
            x = checkpoint(_attn_block_seq, cfg, rep, p, x, windows[li],
                           positions, attn_impl, li, use_reentrant=False)
        else:
            x = _attn_block_seq(cfg, rep, p, x, windows[li], positions,
                                attn_impl, li)
    return x


def forward(cfg: ModelConfig, params, inputs, *, remat: bool = False,
            attn_impl: str | None = None, mesh=None,
            opts: Options = NO_OPTIONS) -> torch.Tensor:
    """Full-sequence logits (B, S, V), or (B, S, K, V) with codebooks, f32.
    ``mesh``, ``opts``: as for ``forward_hidden``."""
    return lm_logits(cfg, params, forward_hidden(cfg, params, inputs,
                                                 remat=remat,
                                                 attn_impl=attn_impl,
                                                 mesh=mesh, opts=opts),
                     mesh=mesh)


# ---------------------------------------------------------------------------
# the training forward over a data replica's model shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataSlices:
    """A leaf the data axes split (``Options.attn_fallback``) as one
    replica's forward reads it: every replica's slice, each on its
    owner's controller, and the dim of the stacked leaf they split."""
    parts: tuple
    dim: int


torch.utils._pytree.register_dataclass(DataSlices,
                                       field_names=["parts", "dim"])


def with_slices(params: list, d: int, dims) -> Dict[str, Any]:
    """Replica ``d``'s tree of ``place_train``'s list with every leaf the
    data axes split (``dims``: ``launch/sharding.py::train_dims``) as a
    ``DataSlices`` of all replicas' slices: what its prefill and decode
    step read."""
    def walk(node, path):
        out = {}
        for k, sub in node.items():
            at = path + (k,)
            if isinstance(sub, dict):
                out[k] = walk(sub, at)
            elif dims[at].data_split:
                out[k] = DataSlices(tuple(leaf_at(p, at) for p in params),
                                    dims[at].data)
            else:
                out[k] = sub
        return out
    return walk(params[d], ())


@dataclasses.dataclass
class _Replica:
    """One data replica's params in the training layout (``launch/
    sharding.py::place_train``) over its ``(1, tp)`` mesh: a leaf split
    over the model axis is a tuple of its shards, shard m on the mesh's
    device m; a replicated leaf is one tensor on the controller; a leaf
    split over the data axes a ``DataSlices``, gathered whole onto the
    controller layer by layer.  The one-device forward is the one-shard
    case: every leaf whole.

    A column product (``col``) runs on each shard over its columns, with
    its slice of a replicated bias; a row product (``row``: wo, wd, the
    expert wd, xLSTM's w_down, Hymba's ssm_out) runs on each shard over
    its rows, and the shards' partial sums, each rounded to the activation
    dtype as ``layers.dense`` rounds a product, are added on the
    controller in shard order in that dtype: the reduction the reference's
    all-reduce makes in the operands' dtype.  Everything else (norms,
    RoPE, residual adds, the recurrent scans, the loss) runs on the
    controller.  Autograd carries the gradients back through the copies;
    a replicated leaf is one tensor, so it gets its summed gradient
    once.  ``opts``: the layout options; ``dispatch``/``index``: the
    capacity MoE's dispatch across data replicas and this one's index."""
    tree: Dict[str, Any]
    mesh: ServingMesh
    opts: Options = NO_OPTIONS
    dispatch: Any = None
    index: int = 0

    @property
    def devices(self) -> List[torch.device]:
        return list(self.mesh.devices)

    @property
    def controller(self) -> torch.device:
        return self.mesh.controller

    def gather(self, parts, dim: int = -1) -> torch.Tensor:
        ctl = self.controller
        if len(parts) == 1:
            return op_analysis.to(parts[0], ctl, "all-gather")
        return torch.cat([op_analysis.to(t, ctl, "all-gather")
                          for t in parts], dim=dim)

    def col(self, w, x, b=None) -> List[torch.Tensor]:
        """x @ w (+ b) by columns: one part per shard of a split ``w``, on
        its device, or one whole product on the controller."""
        if not isinstance(w, tuple):
            return [L.proj(x, w, b)]
        out, lo = [], 0
        for wm, d in zip(w, self.devices):
            n = wm.shape[-1]
            bm = None if b is None else b[..., lo:lo + n].to(d)
            out.append(L.proj(x.to(d), wm, bm))
            lo += n
        return out

    def row(self, w, xs) -> torch.Tensor:
        """The sum over the contraction of ``xs`` (per-shard parts along
        it, or one whole tensor in a list) times ``w``, on the
        controller."""
        if not isinstance(w, tuple):
            return L.proj(self.gather(xs), w)
        if len(xs) != len(w):
            xs = self.gather(xs).split([wm.shape[-2] for wm in w], dim=-1)
        total = None
        for xm, wm, d in zip(xs, w, self.devices):
            part = op_analysis.to(L.proj(xm.to(d), wm), self.controller,
                                  "all-reduce")
            total = part if total is None else total + part
        return total


def _solo(params, device) -> _Replica:
    """``params`` (whole) as a one-shard replica on ``device``."""
    return _Replica(params, ServingMesh((torch.device(device),)))


def _replica(cfg: ModelConfig, params, mesh, opts: Options = NO_OPTIONS,
             dispatch=None, index: int = 0) -> _Replica:
    """The ``_Replica`` of a training-layout tree over ``mesh``, or of a
    whole tree over a one-shard mesh of its device when ``mesh`` is
    None."""
    if mesh is None:
        return _Replica(params, ServingMesh((params["embed"].device,)),
                        opts, dispatch, index)
    if mesh.n_replicas != 1:
        raise ValueError("the training forward runs one data replica: pass "
                         "its (1, tp) mesh (DeviceMesh.replica(d))")
    return _Replica(params, mesh.replica(0), opts, dispatch, index)


def _index(blocks, idx) -> Dict[str, Any]:
    """Layer ``idx`` (an index, or a (period, block) pair) of a stacked
    block tree in the training layout."""
    return {k: tuple(t[idx] for t in w) if isinstance(w, tuple) else w[idx]
            for k, w in blocks.items()}


def _rep_layer(rep: _Replica, li: int) -> Dict[str, Any]:
    """Layer ``li``'s leaves: a data-split leaf's slices gathered whole on
    the controller (in replica order)."""
    blocks = rep.tree["blocks"]
    out = _index({k: w for k, w in blocks.items()
                  if not isinstance(w, DataSlices)}, li)
    for k, w in blocks.items():
        if isinstance(w, DataSlices):
            out[k] = rep.gather([t[li] for t in w.parts], dim=w.dim - 1)
    return out


def _embed_seq(cfg: ModelConfig, rep: _Replica, inputs) -> torch.Tensor:
    """``embed_inputs`` over the shards: each token's row from the shard
    whose vocab slice holds it (codebook by codebook, summed in codebook
    order); the VLM's patches through the column parts of
    ``vision_proj``."""
    tokens, patches = inputs, None
    if isinstance(inputs, Mapping):
        tokens, patches = inputs["tokens"], inputs.get("patch_embeds")
    emb = rep.tree["embed"]
    if isinstance(emb, tuple) and cfg.n_codebooks:
        tokens = tokens.to(rep.controller)
        x = torch.zeros(tokens.shape[:1] + tokens.shape[2:] + (cfg.d_model,),
                        dtype=emb[0].dtype, device=rep.controller)
        for kk in range(cfg.n_codebooks):
            x = x + _vocab_rows([e[kk] for e in emb], rep.devices,
                                tokens[:, kk])
    elif isinstance(emb, tuple):
        x = _vocab_rows(emb, rep.devices, tokens.to(rep.controller))
    else:
        x = embed_inputs(cfg, {"embed": emb}, tokens.to(rep.controller))
    if cfg.family == "vlm" and patches is not None:
        pe = rep.gather(rep.col(rep.tree["vision_proj"],
                                patches.to(rep.controller, cfg.tdtype)))
        x = torch.cat([pe, x], dim=1)
    return x


def heads_split(cfg: ModelConfig, rep: _Replica, p) -> bool:
    """Whether layer ``p``'s attention runs per shard on its whole heads:
    wq and wk split over every shard and the model axis splitting the
    heads whole (``kv_heads_shardable``); else q, k and v are gathered and
    attend on the controller (the fused head columns the reference's
    ``param_spec`` splits tear heads apart there)."""
    tp = len(rep.devices)
    return (isinstance(p["wq"], tuple) and len(p["wq"]) == tp
            and isinstance(p["wk"], tuple) and len(p["wk"]) == tp
            and kv_heads_shardable(cfg, tp))


def _qkv_parts(cfg: ModelConfig, rep: _Replica, p, h, positions,
               whole: bool = False):
    """Layer ``p``'s (q, k, v), each (B, S, heads, hd), q and k roped at
    ``positions``: one triple per shard on its device when
    ``heads_split``, else one gathered on the controller (and always so
    with ``whole``)."""
    B, S, _ = h.shape
    hd = cfg.hd
    qs, ks, vs = (rep.col(p[w], h, p.get(b))
                  for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if whole or not heads_split(cfg, rep, p):
        qs, ks, vs = ([rep.gather(t)] for t in (qs, ks, vs))
    out = []
    for q, k, v in zip(qs, ks, vs):
        pos = positions.to(q.device)
        q = L.apply_rope(q.reshape(B, S, -1, hd), pos, cfg.rope_theta)
        k = L.apply_rope(k.reshape(B, S, -1, hd), pos, cfg.rope_theta)
        out.append((q, k, v.reshape(B, S, -1, hd)))
    return out


def _attend(cfg: ModelConfig, rep: _Replica, q, k, v, window: int,
            attn_impl):
    """``layers.flash_attention`` of one head group; with
    ``Options.flat_gqa`` K/V repeated to every query head first."""
    if rep.opts.flat_gqa and q.shape[2] != k.shape[2]:
        r = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(r, dim=2), v.repeat_interleave(r, dim=2)
    return L.flash_attention(q, k, v, window=window,
                             logit_cap=cfg.attn_logit_softcap,
                             impl=attn_impl)


def _attn_block_seq(cfg: ModelConfig, rep: _Replica, p, x, window: int,
                    positions, attn_impl, li: int = 0):
    """One attention-family block over a whole sequence from position 0
    (the training forward): attention through ``L.flash_attention`` on
    whole heads (``_qkv_parts``), then Hymba's SSM branch from a zero
    state, then the FFN (layer ``li``'s, for the capacity dispatch)."""
    B, S, _ = x.shape
    outs = [_attend(cfg, rep, q, k, v, window, attn_impl).reshape(B, S, -1)
            for q, k, v in _qkv_parts(cfg, rep, p,
                                      L.rms_norm(x, p["ln1"], cfg.norm_eps),
                                      positions)]
    x = x + rep.row(p["wo"], outs)
    if cfg.family == "hybrid":
        x = x + _ssm_branch_seq(cfg, p, x, rep=rep)[0]
    return x + _ffn_seq(cfg, rep, p, x, li)


def _ffn_seq(cfg: ModelConfig, rep: _Replica, p, x, li: int):
    """One layer's FFN (MoE or SwiGLU) of norm(x) over the shards."""
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        return _moe_seq(cfg, rep, p, h2, li)
    return _swiglu_rep(rep, p, h2)


class CapacityDispatch:
    """The capacity MoE's dispatch across a mesh's data replicas.  The
    reference fills each expert's buffer from the whole batch's tokens in
    order, chunk by chunk (``layers.moe_capacity``); data replica ``d`` of
    ``n`` holds the global tokens ``[d * T, (d + 1) * T)``, T the tokens a
    replica holds.  Each replica
    dispatches its part of each chunk into the chunk's global slots: the
    slot of a token is its replica's count of earlier picks of the
    expert plus the earlier replicas' counts in that chunk, which this
    object keeps by (layer, chunk, replica) and hands on (a gather of E
    counts from each earlier replica that holds tokens of the chunk).
    The replicas run in order, so replica d's forward (and its
    checkpoint's recompute) finds every earlier replica's counts."""

    def __init__(self, n: int):
        self.n = n
        self._counts: Dict[tuple, Dict[int, torch.Tensor]] = {}

    def place(self, layer: int, d: int, tokens: int):
        """``layers.moe_capacity_with``'s ``place`` for replica ``d``'s
        ``tokens`` at ``layer``."""
        def before(chunk: int, counts: torch.Tensor) -> torch.Tensor:
            got = self._counts.setdefault((layer, chunk), {})
            got[d] = counts.detach()
            off = torch.zeros_like(counts)
            for r in sorted(got):
                if r < d:
                    off = off + op_analysis.to(got[r], off.device,
                                               "all-gather")
            return off
        return d * tokens, self.n * tokens, before


def _moe_seq(cfg: ModelConfig, rep: _Replica, p, h, li: int = 0):
    """The MoE FFN over the shards in the training layout: the router's
    columns gathered; whole experts a shard (E split) run their gate, up
    and down products there, or (d_ff split) each shard's columns and
    rows of every expert, summed as a row product; the combine on the
    controller in expert order.  Under a ``CapacityDispatch`` the
    capacity dispatch fills the global slots of this replica's tokens."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    tp, devs, ctl = len(rep.devices), rep.devices, rep.controller
    rule = expert_rule(cfg, tp) if isinstance(wg, tuple) else "replicated"

    def routed(xr):
        return L.route_logits(rep.gather(rep.col(p["router"], xr)), k)

    if cfg.moe_impl == "capacity":
        def experts(xbuf):
            if rule == "experts":
                n = E // tp
                return rep.gather([torch.einsum(
                    "eCf,efd->eCd",
                    L.glu_buffers(xbuf[m * n:(m + 1) * n].to(d), wg[m],
                                  wu[m]), wd[m])
                    for m, d in enumerate(devs)], dim=0)
            if rule == "ffn":
                total = None
                for m, d in enumerate(devs):
                    part = torch.einsum("eCf,efd->eCd", L.glu_buffers(
                        xbuf.to(d), wg[m], wu[m]), wd[m]).to(ctl)
                    total = part if total is None else total + part
                return total
            return torch.einsum("eCf,efd->eCd", L.glu_buffers(xbuf, wg, wu),
                                wd)

        place = (None if rep.dispatch is None else rep.dispatch.place(
            li, rep.index, h.shape[0] * h.shape[1]))
        return L.moe_capacity_with(h, routed, experts, E, k, place=place)

    on = {d: h.to(d) for d in dict.fromkeys(devs)}

    def expert(e):
        if rule == "experts":
            m, j = divmod(e, E // tp)
            return L.swiglu(on[devs[m]], wg[m][j], wu[m][j],
                            wd[m][j]).to(ctl)
        if rule == "ffn":
            hs = [F.silu(L.proj(on[d], wg[m][e])) * L.proj(on[d], wu[m][e])
                  for m, d in enumerate(devs)]
            return rep.row(tuple(w[e] for w in wd), hs)
        return L.swiglu(h, wg[e], wu[e], wd[e])

    return L.moe_dense_with(h, routed(h), expert, E)


def _logits_seq(cfg: ModelConfig, rep: _Replica, x) -> torch.Tensor:
    """``lm_logits`` over the shards: each shard's vocab columns (the tied
    embedding's rows), gathered on the controller."""
    x = L.rms_norm(x, rep.tree["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        emb = rep.tree["embed"]
        parts = emb if isinstance(emb, tuple) else (emb,)
        if cfg.n_codebooks:
            logits = rep.gather([torch.einsum("bsd,kvd->bskv",
                                              x.to(e.device), e)
                                 for e in parts])
        else:
            logits = rep.gather([torch.matmul(x.to(e.device), e.t())
                                 for e in parts])
    else:
        logits = rep.gather(rep.col(rep.tree["lm_head"], x))
        if cfg.n_codebooks:
            logits = logits.reshape(x.shape[:2] + (cfg.n_codebooks,
                                                   cfg.vocab_size))
    if cfg.final_logit_softcap:
        logits = L.softcap(logits.float(), cfg.final_logit_softcap)
    return logits.float()


# ---------------------------------------------------------------------------
# the reference's prefill and decode step over a data replica's shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SeqSlices:
    """A decode cache's K or V with its sequence split over a
    ``DeviceMesh``'s data replicas (distributed-context decode,
    ``launch/sharding.py::cache_layout``): replica d's slice of positions
    ``[d S / n, (d + 1) S / n)`` on its devices, as one tensor on its
    controller or a tuple of one part a model shard."""
    parts: tuple


torch.utils._pytree.register_dataclass(SeqSlices, field_names=["parts"])


def _parts(t) -> tuple:
    return t if isinstance(t, tuple) else (t,)


def _slices(kv) -> tuple:
    """A cache K or V as its slices (one unless the sequence is split),
    each a tuple of its parts (one a model shard, or the whole)."""
    return tuple(_parts(p) for p in
                 (kv.parts if isinstance(kv, SeqSlices) else (kv,)))


def _split(cfg: ModelConfig, parts: tuple) -> str:
    """The model split of one slice's parts: ``cache_layout``'s model."""
    if len(parts) == 1:
        return "none"
    return "heads" if parts[0].shape[-1] == cfg.hd else "hd"


def _piece(parts, model: str, m: int, tp: int) -> torch.Tensor:
    """Shard ``m``'s piece of a (B, S, heads, hd) tensor in the cache's
    model split: its own part when ``parts`` has one a shard, else a cut
    of the whole one (its heads, or its hd slice)."""
    if len(parts) == tp:
        return parts[m]
    whole = parts[0]
    if model == "none":
        return whole
    dim = 2 if model == "heads" else 3
    n = whole.shape[dim] // tp
    return whole.narrow(dim, m * n, n)


def _row0(mesh):
    """Replica 0's mesh of a ``DeviceMesh`` or ``ServingMesh`` (None stays
    None)."""
    return None if mesh is None else mesh.replica(0)


def _cache_kv(cfg: ModelConfig, lay, mesh, max_len: int, ctl, make):
    """One of K or V in ``lay`` (a ``CacheLayout``), made by ``make``
    (``torch.zeros``/``torch.empty``)."""
    S = max_len // lay.seq_parts

    def one(row, device):
        dims = (cfg.n_layers, lay.rows, S)
        if lay.model == "none":
            return make(dims + (cfg.n_kv_heads, cfg.hd), dtype=cfg.tdtype,
                        device=device)
        tp = len(row.devices)
        shape = dims + ((cfg.n_kv_heads // tp, cfg.hd) if lay.model == "heads"
                        else (cfg.n_kv_heads, cfg.hd // tp))
        return tuple(make(shape, dtype=cfg.tdtype, device=d)
                     for d in row.devices)

    if lay.seq_parts == 1:
        return one(_row0(mesh), ctl)
    rows = [mesh.replica(d) for d in range(lay.seq_parts)]
    return SeqSlices(tuple(one(r, r.controller) for r in rows))


def replica_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                         params=None, mesh=None,
                         opts: Options = NO_OPTIONS):
    """The dense decode cache of ``replica_decode_step`` for a global
    ``batch``, laid out by ``launch/sharding.py::cache_layout``: {"k",
    "v"} each replica 0's rows (``batch`` / data when the data axes divide
    it) as a tuple of one (L, B, max_len, KV / tp, hd) (whole heads) or
    (L, B, max_len, KV, hd / tp) (hd over model) part a shard, or one (L,
    B, max_len, KV, hd) tensor on the controller; or, when the sequence
    splits over a ``DeviceMesh``'s data replicas, a ``SeqSlices`` of each
    replica's max_len / data positions so laid out on its devices.  Zeros
    in ``cfg.tdtype``.  The recurrent state (Hymba's "ssm", xLSTM's
    state) is replica 0's rows laid out by ``launch/sharding.py::
    state_layout``: a leaf split over model a tuple of one part a shard
    on its device, any other leaf whole on the controller.  ``mesh``: a
    ``DeviceMesh``, one replica's ``ServingMesh``, or None (a one-shard
    mesh of ``params``' device)."""
    rep = _replica(cfg, params, _row0(mesh), opts)
    ctl = rep.controller
    if cfg.family in ("ssm", "hybrid"):
        slay = state_layout(cfg, mesh, batch)
        state = (_xlstm_init_state(cfg, slay.rows, ctl)
                 if cfg.family == "ssm" else
                 {"ssm": _hybrid_ssm_init(cfg, slay.rows, ctl)})
        state = place_state(state, slay, rep.devices)
        if cfg.family == "ssm":
            return state
    lay = cache_layout(cfg, mesh, batch, max_len)
    cache = {n: _cache_kv(cfg, lay, mesh, max_len, ctl, torch.zeros)
             for n in ("k", "v")}
    if cfg.family == "hybrid":
        cache.update(state)
    return cache


def _write_prefix(cfg: ModelConfig, kv, li: int, parts) -> None:
    """Write a prefill's K or V (``parts``: one (B, S, heads, hd) a shard,
    or the whole) into layer ``li`` of the cache ``kv`` from position 0,
    each slice its positions, each shard its piece."""
    S = parts[0].shape[1]
    for d, sl in enumerate(_slices(kv)):
        size = sl[0].shape[2]
        off = d * size
        n = min(size, S - off)
        if n <= 0:
            break
        model = _split(cfg, sl)
        for m, dst in enumerate(sl):
            dst[li][:, :n] = _piece(parts, model, m, len(sl))[:, off:off + n]


def replica_prefill(cfg: ModelConfig, params, inputs, *, mesh=None,
                    opts: Options = NO_OPTIONS,
                    attn_impl: str | None = None, max_len: int | None = None):
    """The reference's ``prefill`` from position 0 over replica 0's
    training layout (``place_train``; the compile analysis's prefill):
    (logits_last (B, 1, [K,] V) f32, cache).  The cache holds ``max_len``
    positions (default: the sequence's), the sequence's written from 0,
    in ``replica_decode_cache``'s layout, so ``replica_decode_step``
    continues from it (xLSTM: the state after it; Hymba adds "ssm"): the
    scans run whole on the controller, and their final state is then
    split into ``state_layout``, each shard taking its piece.
    ``mesh``: as for ``replica_decode_cache``; a ``DeviceMesh`` whose data
    axes divide the batch prefills replica 0's rows of ``inputs`` (the
    others do the same work on theirs).  The attention runs on replica
    0's shards on whole heads, or on its controller when the heads do not
    split; with ``opts.seq_par`` q, k and v are gathered and it runs
    through ``layers.flash_attention_seqpar`` over the replica's
    devices."""
    _check_family(cfg)
    rep = _replica(cfg, params, _row0(mesh), opts)
    tokens = inputs["tokens"] if isinstance(inputs, Mapping) else inputs
    rows = cache_layout(cfg, mesh, tokens.shape[0], 1).rows
    if rows != tokens.shape[0]:
        inputs = ({k: t[:rows] for k, t in inputs.items()}
                  if isinstance(inputs, Mapping) else inputs[:rows])
    x = _embed_seq(cfg, rep, inputs)
    B, S = x.shape[:2]
    slay = state_layout(cfg, mesh, tokens.shape[0])
    if cfg.family == "ssm":
        x, state = _run_xlstm(cfg, rep, x,
                              _xlstm_init_state(cfg, B, x.device))
        return (_logits_seq(cfg, rep, x[:, -1:]),
                place_state(state, slay, rep.devices))
    max_len = S if max_len is None else max_len
    lay = cache_layout(cfg, mesh, tokens.shape[0], max_len)
    make = torch.empty if max_len == S else torch.zeros
    cache = {n: _cache_kv(cfg, lay, mesh, max_len, rep.controller, make)
             for n in ("k", "v")}
    windows = cfg.layer_windows()
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    new_ssm = []
    for li in range(cfg.n_layers):
        p = _rep_layer(rep, li)
        parts = _qkv_parts(cfg, rep, p, L.rms_norm(x, p["ln1"], cfg.norm_eps),
                           positions, whole=opts.seq_par)
        _write_prefix(cfg, cache["k"], li, [k for _, k, _ in parts])
        _write_prefix(cfg, cache["v"], li, [v for _, _, v in parts])
        outs = []
        for q, k, v in parts:
            if opts.seq_par:
                o = L.flash_attention_seqpar(
                    q, k, v, window=windows[li],
                    logit_cap=cfg.attn_logit_softcap, devices=rep.devices,
                    impl=attn_impl)
            else:
                o = _attend(cfg, rep, q, k, v, windows[li], attn_impl)
            outs.append(o.reshape(B, S, -1))
        x = x + rep.row(p["wo"], outs)
        if cfg.family == "hybrid":
            y, st = _ssm_branch_seq(cfg, p, x, rep=rep)
            x = x + y
            new_ssm.append(st)
        x = x + _ffn_seq(cfg, rep, p, x, li)
    if new_ssm:
        cache.update(place_state({"ssm": torch.stack(new_ssm)}, slay,
                                 rep.devices))
    return _logits_seq(cfg, rep, x[:, -1:]), cache


def _write_token(c, t, pos, off: int, seq: bool) -> None:
    """Write the new token's (B, heads, hd) ``t`` in place at position
    ``pos - 1`` of the cache layer ``c`` (B, S, heads, hd), which holds
    positions ``[off, off + S)``; with ``seq`` (one slice of a split
    sequence) a row whose position lies in another slice keeps its own."""
    bidx = torch.arange(c.shape[0], device=c.device)
    at = (pos - 1).long() - off
    t = t.to(c.dtype)
    if seq:
        own = (at >= 0) & (at < c.shape[1])
        at = at.clamp(0, c.shape[1] - 1)
        t = torch.where(own[:, None, None], t, c[bidx, at])
    c[bidx, at] = t


def _partial_attend(cfg: ModelConfig, q, kc, vc, pos, off: int,
                    window: int):
    """One slice's (m, l, o) over its whole heads (``layers.
    decode_partial``; o = e . V unnormalised, f32)."""
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = L.decode_scores(torch.einsum("bgrd,bkgd->bgrk", qg, kc.float()),
                        pos, hd, offset=off, window=window,
                        logit_cap=cfg.attn_logit_softcap)
    m, e, l = L.decode_partial(s)
    return m, l, torch.einsum("bgrk,bkgd->bgrd", e, vc.float())


def _slice_attend(cfg: ModelConfig, row, model: str, sent, kd, vd, li: int,
                  off: int, window: int, partial: bool) -> list:
    """Layer ``li``'s attention over one slice (``kd``/``vd``, positions
    from ``off``) on its replica's devices ``row``, the new token written
    first; ``sent``: each part's (q, k, v, pos) pieces on its device.
    Whole heads, or no split: one result a part, on its device, through
    ``layers.decode_attention`` (or ``_partial_attend``).  hd over model:
    each shard's partial scores q_m . K_m in f32 are added on the
    controller in shard order (the reference's all-reduce), the scale,
    softcap, masks and softmax run there, and each shard's P . V_m slice
    is gathered along hd: one result, on the controller.  ``partial``:
    results (m, l, o) for ``layers.merge_partials``, else the outputs (B,
    1, heads * hd) in q's dtype."""
    seq = partial
    for (_, k, v, p), kc, vc in zip(sent, kd, vd):
        _write_token(kc[li], k[:, 0], p, off, seq)
        _write_token(vc[li], v[:, 0], p, off, seq)
    cap = cfg.attn_logit_softcap
    if model != "hd":
        out = []
        for (q, _, _, p), kc, vc in zip(sent, kd, vd):
            if partial:
                out.append(_partial_attend(cfg, q, kc[li], vc[li], p, off,
                                           window))
            else:
                out.append(L.decode_attention(
                    q, kc[li], vc[li], pos=p, window=window,
                    logit_cap=cap).reshape(q.shape[0], 1, -1))
        return out
    ctl = row.controller
    raw = None
    for (q, _, _, _), kc in zip(sent, kd):
        B, _, H, n = q.shape
        KV = kc.shape[3]
        qg = q.reshape(B, KV, H // KV, n).float()
        s = op_analysis.to(torch.einsum("bgrd,bkgd->bgrk", qg,
                                        kc[li].float()), ctl, "all-reduce")
        raw = s if raw is None else raw + s
    s = L.decode_scores(raw, sent[0][3], cfg.hd, offset=off, window=window,
                        logit_cap=cap)
    if partial:
        m, p, l = L.decode_partial(s)
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.cat([op_analysis.to(torch.einsum(
        "bgrk,bkgd->bgrd", p.to(vc.device), vc[li].float()), ctl,
        "all-gather") for vc in vd], dim=-1)
    if partial:
        return [(m, l, o)]
    return [o.reshape(B, 1, -1).to(sent[0][0].dtype)]


def _stand_in(cfg: ModelConfig, row, model: str, kd, B: int) -> list:
    """The partials of a slice the step does not compute (the compile
    analysis's stand-ins): neutral ones of the computed slices' shapes,
    on the devices that would hold them."""
    R = cfg.n_heads // cfg.n_kv_heads
    where = ([(row.controller, cfg.n_kv_heads)] if model == "hd" else
             [(kc.device, kc.shape[3]) for kc in kd])
    return [(torch.full((B, kv, R), L.NEG_INF, device=dev),
             torch.zeros((B, kv, R), device=dev),
             torch.zeros((B, kv, R, cfg.hd), device=dev))
            for dev, kv in where]


def _decode_attend(cfg: ModelConfig, rep: _Replica, rows, parts, cache,
                   li: int, pos, window: int, computed) -> list:
    """Layer ``li``'s decode attention of this step's (q, k, v) ``parts``
    over the cache: the outputs (B, 1, heads * hd), one a shard of
    replica 0 (whole heads) or one on its controller.  Each slice's
    devices get their pieces of q, k, v and pos from replica 0 and attend
    to it (``_slice_attend``); over a split sequence each slice gives its
    partial (m, l, o), merged in replica order where replica 0 holds the
    result (distributed-context decode).  Slices from index ``computed``
    on get their pieces but stand in (``_stand_in``)."""
    ks, vs = _slices(cache["k"]), _slices(cache["v"])
    model, tp = _split(cfg, ks[0]), len(ks[0])
    partial = len(ks) > 1
    B = pos.shape[0]
    results = []
    for d, (row, kd, vd) in enumerate(zip(rows, ks, vs)):
        sent = [tuple(_piece([t[j] for t in parts], model, m, tp).to(kc.device)
                      for j in range(3)) + (pos.to(kc.device),)
                for m, kc in enumerate(kd)]
        if computed is not None and d >= computed:
            results.append(_stand_in(cfg, row, model, kd, B))
        else:
            results.append(_slice_attend(cfg, row, model, sent, kd, vd, li,
                                         d * kd[0].shape[2], window, partial))
    if not partial:
        return results[0]
    dtype = parts[0][0].dtype
    where = rep.devices[:tp] if model == "heads" else [rep.controller]
    return [L.merge_partials([r[j] for r in results], dev)
            .reshape(B, 1, -1).to(dtype) for j, dev in enumerate(where)]


def replica_decode_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                        mesh=None, opts: Options = NO_OPTIONS,
                        computed: int | None = None):
    """The reference's ``decode_step`` over replica 0's training layout:
    one token (B, 1) or (B, K, 1) over ``replica_decode_cache``'s cache,
    written in place at ``pos - 1`` (the recurrent state too, in place),
    attention as the reference's plain ``layers.decode_attention``
    computes it (``_decode_attend``); returns the (B, 1, [K,] V) f32
    logits on replica 0's controller.  Everything but the attention and
    the split recurrent state runs on replica 0's controller; over a
    ``DeviceMesh`` whose data replicas split the cache's sequence, each
    replica attends to its slice; each shard steps its part of a state
    leaf split over model (``_mlstm_parts``, ``_slstm_parts``,
    ``_conv_parts``, ``_ssm_parts``).  ``computed``: the slices that
    attend (the compile analysis traces replica 0 alone, 1; None:
    all)."""
    _check_family(cfg)
    rep = _replica(cfg, params, _row0(mesh), opts)
    x = _embed_seq(cfg, rep, tokens)
    if cfg.family == "ssm":
        x, _ = _run_xlstm(cfg, rep, x, cache, inplace=True)
        return _logits_seq(cfg, rep, x)
    windows = cfg.layer_windows()
    pos = pos.to(rep.controller)
    rope_pos = (pos - 1)[:, None]
    rows = ([mesh.replica(d) for d in range(len(cache["k"].parts))]
            if isinstance(cache["k"], SeqSlices) else [rep.mesh])
    for li in range(cfg.n_layers):
        p = _rep_layer(rep, li)
        parts = _qkv_parts(cfg, rep, p, L.rms_norm(x, p["ln1"], cfg.norm_eps),
                           rope_pos)
        x = x + rep.row(p["wo"], _decode_attend(cfg, rep, rows, parts, cache,
                                                li, pos, windows[li],
                                                computed))
        if cfg.family == "hybrid":
            y, st = _ssm_branch_seq(cfg, p, x, _at(cache["ssm"], li),
                                    rep=rep)
            x = x + y
            _put(cache["ssm"], li, st)
        x = x + _ffn_seq(cfg, rep, p, x, li)
    return _logits_seq(cfg, rep, x)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cpu") -> Dict[str, Any]:
    """Zeroed dense decode cache: {"k", "v"} each (L, B, max_len, KV, hd),
    and for the hybrid family "ssm" (L, B, H, hd, N) f32; for the ssm
    family the fresh recurrent state."""
    if cfg.family == "ssm":
        return _xlstm_init_state(cfg, batch, device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}
    if cfg.family == "hybrid":
        cache["ssm"] = _hybrid_ssm_init(cfg, batch, device)
    return cache


def prefill(cfg: ModelConfig, params, tokens, prefix_cache=None,
            prefix_len: int = 0, *, attn_impl: str | None = None,
            patch_embeds: torch.Tensor | None = None, mesh=None):
    """Serving prefill over an optional cached document prefix.

    tokens: (B, S) ids of the new tokens, the first at absolute position
    ``prefix_len``; (B, K, S) for codebook models.  prefix_cache: {"k",
    "v"} each (L, B, prefix_len, KV, hd) — the RAGCache hook, the knowledge
    tree's cached prefix; for the hybrid family also "ssm", the state after
    the prefix; for the ssm family the recurrent state after it (see the
    module docstring), which ``prefix_len`` does not size.  Returns
    (logits_last (B, 1, V) f32, cache) where the cache holds the FULL
    sequence, (L, B, prefix_len + S, KV, hd), so the caller can page the
    new documents' KV into the tree, and the state after it (new tensors;
    the prefix's state is only read).  Each layer's K/V is written into
    that cache once and attended from it in place.  patch_embeds: (B,
    Simg, D) for the VLM family, prepended (projected) ahead of the tokens,
    so S counts Simg + the token count.  mesh: tensor-parallel serving
    (see the module docstring); the cache and the attention stay on the
    controller.
    """
    _check_family(cfg)
    sh = _shards(cfg, params, mesh)
    if not trivial(sh.mesh) and patch_embeds is not None:
        raise ValueError("tensor-parallel prefill serves the text backbone; "
                         "it takes no patch embeddings")
    params = sh.params[0]
    x = _embed(cfg, sh, tokens) if patch_embeds is None else \
        embed_inputs(cfg, params, tokens, patch_embeds)
    B, S = x.shape[:2]
    if cfg.family == "ssm":
        state = (prefix_cache if prefix_cache is not None
                 else _xlstm_init_state(cfg, B, tokens.device))
        x, new_state = _run_xlstm(cfg, params, x, state)
        return _logits(cfg, sh, x[:, -1:]), new_state
    P = int(prefix_len)
    if prefix_cache is not None and prefix_cache["k"].shape[2] != P:
        raise ValueError(f"prefix cache holds {prefix_cache['k'].shape[2]} "
                         f"tokens, prefix_len is {P}")
    cache = init_decode_cache(cfg, B, P + S, device=tokens.device)
    if prefix_cache is not None:
        cache["k"][:, :, :P] = prefix_cache["k"]
        cache["v"][:, :, :P] = prefix_cache["v"]
    hybrid = cfg.family == "hybrid"
    if hybrid:
        ssm0 = prefix_cache["ssm"] if prefix_cache is not None else None
        new_ssm = []
    windows = cfg.layer_windows()
    positions = P + torch.arange(S, dtype=torch.int32, device=tokens.device)
    for li in range(cfg.n_layers):
        ps = sh.layers(li)
        p = ps[0]
        q, k, v = _attn_in(cfg, sh, ps, x)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        cache["k"][li, :, P:] = L.apply_rope(k, positions, cfg.rope_theta)
        cache["v"][li, :, P:] = v
        o = L.flash_attention(q, cache["k"][li], cache["v"][li],
                              q_offset=P, window=windows[li],
                              logit_cap=cfg.attn_logit_softcap,
                              impl=attn_impl)
        x = x + L.dense_rowsum(o.reshape(B, S, -1), p["wo"])
        if hybrid:
            y, st = _ssm_branch_seq(cfg, p, x,
                                    None if ssm0 is None else ssm0[li])
            x = x + y
            new_ssm.append(st)
        x = _ffn_out(cfg, sh, ps, x)
    if hybrid:
        cache["ssm"] = torch.stack(new_ssm)
    return _logits(cfg, sh, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                mesh=None) -> torch.Tensor:
    """One decode iteration over a dense cache.

    tokens: (B, 1), or (B, K, 1) for codebook models.  cache: {"k", "v"}
    each (L, B, Smax, KV, hd) — MUTATED IN PLACE: each layer writes the new
    token's K/V at position pos - 1 before attending.  The recurrent state
    (the hybrid family's "ssm", the ssm family's whole cache) is never
    written: the step replaces the dict's entries with new state tensors.
    pos: (B,) sequence length including that token.  Returns the (B, 1,
    V) f32 logits.  mesh: tensor-parallel serving (see the module
    docstring); the cache and the attention stay on the controller.
    """
    _check_family(cfg)
    sh = _shards(cfg, params, mesh)
    params = sh.params[0]
    x = _embed(cfg, sh, tokens)
    if cfg.family == "ssm":
        x, new_state = _run_xlstm(cfg, params, x, cache)
        cache.update(new_state)
        return _logits(cfg, sh, x)
    B = x.shape[0]
    windows = cfg.layer_windows()
    rope_pos = (pos - 1)[:, None]
    bidx = torch.arange(B, device=tokens.device)
    at = (pos - 1).long()
    new_ssm = []
    for li in range(cfg.n_layers):
        ps = sh.layers(li)
        p = ps[0]
        q, k, v = _attn_in(cfg, sh, ps, x)                 # S == 1
        q = L.apply_rope(q, rope_pos, cfg.rope_theta)
        k = L.apply_rope(k, rope_pos, cfg.rope_theta)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[bidx, at] = k[:, 0].to(kc.dtype)
        vc[bidx, at] = v[:, 0].to(vc.dtype)
        o = L.decode_attention(q, kc, vc, pos=pos, window=windows[li],
                               logit_cap=cfg.attn_logit_softcap)
        x = x + L.dense_rowsum(o.reshape(B, 1, -1), p["wo"])
        if cfg.family == "hybrid":
            y, st = _ssm_branch_seq(cfg, p, x, cache["ssm"][li])
            x = x + y
            new_ssm.append(st)
        x = _ffn_out(cfg, sh, ps, x)
    if new_ssm:
        cache["ssm"] = torch.stack(new_ssm)
    return _logits(cfg, sh, x)


def _write_kv(sh: _Shards, planes, li: int, index, kv) -> None:
    """Write layer li's new K or V (..., KV, hd), on the controller, into
    each shard's pool plane at ``index`` (a (blk, slot) pair per device):
    shard i takes its KV / tp heads."""
    n = kv.shape[-2] // sh.tp
    for i, (plane, dev) in enumerate(zip(planes, sh.devices)):
        part = kv[..., i * n:(i + 1) * n, :]
        plane[li].index_put_(index[dev], part.to(dev, plane.dtype))


def _per_device(sh: _Shards, *ts) -> dict:
    """``ts`` copied once to each of the shards' devices."""
    return {d: tuple(t.to(d) for t in ts) for d in dict.fromkeys(sh.devices)}


def paged_decode_step(cfg: ModelConfig, params, tokens, k_pages, v_pages,
                      tables, counts, starts, write_blk, write_slot, pos,
                      *, attn_impl: str | None = None,
                      mesh=None) -> torch.Tensor:
    """One decode iteration straight against the paged pool.

    tokens: (B, 1).  k_pages/v_pages: the ``PagedKVStore`` planes (a
    list, one (L, n_blocks, block, KV / tp, hd) plane a shard),
    (L, n_blocks, block, KV, hd) — MUTATED IN PLACE: each layer writes the
    new token's K/V at (write_blk, write_slot), (B,) each, before its
    attention reads the pool.  tables/counts/starts: (B, n_slots) int32 run
    descriptors whose counts already include that token.  pos: (B,) int32
    sequence length including it.  Returns the (B, 1, V) f32 logits.
    Attention families only: recurrent state cannot be paged per block.
    mesh: tensor-parallel serving; the run tables and write coordinates
    are the same for every shard.
    """
    _check_family(cfg)
    _check_paged(cfg)
    sh = _shards(cfg, params, mesh)
    x = _embed(cfg, sh, tokens)
    B = x.shape[0]
    windows = cfg.layer_windows()
    rope_pos = (pos - 1)[:, None]
    index = _per_device(sh, write_blk.long(), write_slot.long())
    for li in range(cfg.n_layers):
        ps = sh.layers(li)
        q, k, v = _attn_in(cfg, sh, ps, x)                 # S == 1
        q = L.apply_rope(q, rope_pos, cfg.rope_theta)
        k = L.apply_rope(k, rope_pos, cfg.rope_theta)
        _write_kv(sh, k_pages, li, index, k[:, 0])
        _write_kv(sh, v_pages, li, index, v[:, 0])
        o = ops.paged_decode_attention(
            q[:, 0].contiguous(), k_pages, v_pages, tables, counts, starts,
            pos - 1, li, windows[li], logit_cap=cfg.attn_logit_softcap,
            impl=attn_impl, mesh=sh.mesh)
        x = x + L.dense_rowsum(o.reshape(B, 1, -1), ps[0]["wo"])
        x = _ffn_out(cfg, sh, ps, x)
    return _logits(cfg, sh, x)


def paged_prefill_step(cfg: ModelConfig, params, tokens, k_pages, v_pages,
                       tables, counts, starts, q_start, q_len, write_blk,
                       write_slot, *, attn_impl: str | None = None,
                       mesh=None) -> torch.Tensor:
    """One ragged prefill chunk computed straight against the paged pool.

    tokens: (B, Sq) right-padded rows; row ``b`` holds ``q_len[b]`` valid
    tokens whose first sits at absolute position ``q_start[b]``.
    k_pages/v_pages: the pool tensors — MUTATED IN PLACE: each layer
    scatters the chunk's K/V at (write_blk, write_slot), (B, Sq) each,
    before attention (padding rows point at the store's scratch block,
    which no live run reads).  tables/counts/starts: (B, n_slots) run
    descriptors covering the cached prefix plus this chunk.  Returns the
    (B, 1, V) f32 logits at each row's last valid token.  Attention
    families only.  mesh: as for ``paged_decode_step``.
    """
    _check_family(cfg)
    _check_paged(cfg)
    sh = _shards(cfg, params, mesh)
    x = _embed(cfg, sh, tokens)
    B, Sq = tokens.shape
    windows = cfg.layer_windows()
    positions = q_start[:, None] + torch.arange(
        Sq, dtype=torch.int32, device=tokens.device)[None]
    index = _per_device(sh, write_blk.long(), write_slot.long())
    for li in range(cfg.n_layers):
        ps = sh.layers(li)
        q, k, v = _attn_in(cfg, sh, ps, x)                 # (B, Sq, ., hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        _write_kv(sh, k_pages, li, index, k)
        _write_kv(sh, v_pages, li, index, v)
        # q is read in place through its strides; on the card o is a view
        # of a (B, Sq, H, hd) buffer, so neither side is copied at tp 1
        o = ops.paged_prefill_attention(
            q.transpose(1, 2), k_pages, v_pages, tables, counts, starts,
            q_start, q_len, li, windows[li],
            logit_cap=cfg.attn_logit_softcap, impl=attn_impl, mesh=sh.mesh)
        x = x + L.dense_rowsum(o.transpose(1, 2).reshape(B, Sq, -1),
                               ps[0]["wo"])
        x = _ffn_out(cfg, sh, ps, x)
    last = torch.clamp(q_len.long() - 1, 0, Sq - 1)
    x_last = torch.gather(x, 1, last[:, None, None].expand(B, 1, x.shape[-1]))
    return _logits(cfg, sh, x_last)
