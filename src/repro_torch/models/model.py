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

The attention families are ported: dense (GQA or MHA, an optional QKV
bias, optional sliding windows), MoE (the dense block with a routed
expert FFN, ``moe_impl`` dense or capacity) and VLM (the dense block
behind an optional projected patch-embedding prefix, which only
``prefill`` takes: the runtimes serve the text backbone).  They serve
Qwen2-0.5B (GQA with a QKV bias, hd 64), the paper's evaluation models,
Mistral-7B (GQA R 4, a 4096-token window on every layer, hd 128) and
LLaMA2-7B (MHA, hd 128), Mixtral-8x7B, Phi-3.5-MoE and InternVL2-1B; audio
and the recurrent families wait (ROADMAP.md Queue A).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.n_codebooks:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue A); "
            f"the port serves {', '.join(FAMILIES)}")


def init_params(cfg: ModelConfig, seed: int,
                device="cpu") -> Dict[str, Any]:
    """Seeded random params (the JAX package's init scheme and tree —
    normal(0, 0.02), output projections scaled by 1/sqrt(2L), zero norms
    and biases — drawn from one ``torch.Generator``).

    Each tensor is drawn whole in f32 and cast, except the expert weights,
    which are drawn one (layer, expert) slice at a time into a tensor
    allocated in the params' dtype, so that the transient f32 is one
    slice (Mixtral-8x7B's whole stacked expert tensor would be 45 GB in
    f32).  The dense families draw from the stream in the order they
    always have; the MoE and VLM tensors are drawn where they appear in
    the tree."""
    _check_family(cfg)
    D, F, V, nl = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.tdtype
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scale = 0.02
    out_scale = scale / (2 * nl) ** 0.5

    def mk(shape, s=scale):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * s).to(dt)

    def mk_slices(shape, s=scale):
        # drawn over the two leading axes, (layer, expert), slice by slice
        w = torch.empty(shape, dtype=dt, device=device)
        for li in range(shape[0]):
            for e in range(shape[1]):
                w[li, e] = mk(shape[2:], s)
        return w

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    params: Dict[str, Any] = {"embed": mk((V, D))}
    if cfg.family == "vlm":
        params["vision_proj"] = mk((D, D))
    params["final_norm"] = zeros((D,))
    if not cfg.tie_embeddings:
        params["lm_head"] = mk((D, V))
    blk = {
        "ln1": zeros((nl, D)),
        "wq": mk((nl, D, H * hd)),
        "wk": mk((nl, D, KV * hd)),
        "wv": mk((nl, D, KV * hd)),
        "wo": mk((nl, H * hd, D), out_scale),
        "ln2": zeros((nl, D)),
    }
    if cfg.moe_experts:
        E = cfg.moe_experts
        blk["router"] = mk((nl, D, E))
        blk["wg"] = mk_slices((nl, E, D, F))
        blk["wu"] = mk_slices((nl, E, D, F))
        blk["wd"] = mk_slices((nl, E, F, D), out_scale)
    else:
        blk["wg"] = mk((nl, D, F))
        blk["wu"] = mk((nl, D, F))
        blk["wd"] = mk((nl, F, D), out_scale)
    if cfg.qkv_bias:
        blk["bq"] = zeros((nl, H * hd))
        blk["bk"] = zeros((nl, KV * hd))
        blk["bv"] = zeros((nl, KV * hd))
    params["blocks"] = blk
    return params


def params_from_numpy(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device="cpu") -> Dict[str, Any]:
    """Params from the flat dict that ``repro/training/checkpoint.py::save``
    writes: ``/``-joined keys (``"blocks/wq"``), bf16 stored as f32.  The
    cast to ``cfg.tdtype`` is lossless for bf16-representable values."""
    _check_family(cfg)
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        if key.startswith("__"):            # checkpoint metadata (__step__)
            continue
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        t = torch.tensor(np.asarray(arr, dtype=np.float32))
        node[leaf] = t.to(device=device, dtype=cfg.tdtype)
    return out


def embed_inputs(cfg: ModelConfig, params, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None):
    """(B, S) token ids -> (B, S, D) embeddings; for the VLM family with
    ``patch_embeds`` (B, Simg, D), their projection through
    ``vision_proj`` is prepended: (B, Simg + S, D)."""
    x = params["embed"][tokens]
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = L.proj(patch_embeds.to(cfg.tdtype), params["vision_proj"])
        x = torch.cat([pe, x], dim=1)
    return x


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].t())
    else:
        logits = L.proj(x, params["lm_head"])
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


def _qkv(cfg: ModelConfig, p, h):
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = L.proj(h, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = L.proj(h, p["wk"], p.get("bk")).reshape(B, S, KV, hd)
    v = L.proj(h, p["wv"], p.get("bv")).reshape(B, S, KV, hd)
    return q, k, v


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed dense decode cache: {"k", "v"} each (L, B, max_len, KV, hd)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def prefill(cfg: ModelConfig, params, tokens, prefix_cache=None,
            prefix_len: int = 0, *, attn_impl: str | None = None,
            patch_embeds: torch.Tensor | None = None):
    """Serving prefill over an optional cached document prefix.

    tokens: (B, S) ids of the new tokens, the first at absolute position
    ``prefix_len``.  prefix_cache: {"k", "v"} each (L, B, prefix_len, KV,
    hd) — the RAGCache hook, the knowledge tree's cached prefix.  Returns
    (logits_last (B, 1, V) f32, cache) where the cache holds the FULL
    sequence, (L, B, prefix_len + S, KV, hd), so the caller can page the
    new documents' KV into the tree.  Each layer's K/V is written into that
    cache once and attended from it in place.  patch_embeds: (B, Simg, D)
    for the VLM family, prepended (projected) ahead of the tokens, so S
    counts Simg + the token count.
    """
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    B, S = x.shape[:2]
    P = int(prefix_len)
    if prefix_cache is not None and prefix_cache["k"].shape[2] != P:
        raise ValueError(f"prefix cache holds {prefix_cache['k'].shape[2]} "
                         f"tokens, prefix_len is {P}")
    cache = init_decode_cache(cfg, B, P + S, device=tokens.device)
    if prefix_cache is not None:
        cache["k"][:, :, :P] = prefix_cache["k"]
        cache["v"][:, :, :P] = prefix_cache["v"]
    windows = cfg.layer_windows()
    positions = P + torch.arange(S, dtype=torch.int32, device=tokens.device)
    for li in range(cfg.n_layers):
        p = _layer(params, li)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        cache["k"][li, :, P:] = L.apply_rope(k, positions, cfg.rope_theta)
        cache["v"][li, :, P:] = v
        o = L.flash_attention(q, cache["k"][li], cache["v"][li],
                              q_offset=P, window=windows[li],
                              logit_cap=cfg.attn_logit_softcap,
                              impl=attn_impl)
        x = x + L.proj(o.reshape(B, S, -1), p["wo"])
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h2)
    return lm_logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, tokens, cache, pos) -> torch.Tensor:
    """One decode iteration over a dense cache.

    tokens: (B, 1).  cache: {"k", "v"} each (L, B, Smax, KV, hd) — MUTATED
    IN PLACE: each layer writes the new token's K/V at position pos - 1
    before attending.  pos: (B,) sequence length including that token.
    Returns the (B, 1, V) f32 logits.
    """
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens)
    B = x.shape[0]
    windows = cfg.layer_windows()
    rope_pos = (pos - 1)[:, None]
    bidx = torch.arange(B, device=tokens.device)
    at = (pos - 1).long()
    for li in range(cfg.n_layers):
        p = _layer(params, li)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)                          # S == 1
        q = L.apply_rope(q, rope_pos, cfg.rope_theta)
        k = L.apply_rope(k, rope_pos, cfg.rope_theta)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[bidx, at] = k[:, 0].to(kc.dtype)
        vc[bidx, at] = v[:, 0].to(vc.dtype)
        o = L.decode_attention(q, kc, vc, pos=pos, window=windows[li],
                               logit_cap=cfg.attn_logit_softcap)
        x = x + L.proj(o.reshape(B, 1, -1), p["wo"])
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h2)
    return lm_logits(cfg, params, x)


def paged_decode_step(cfg: ModelConfig, params, tokens, k_pages, v_pages,
                      tables, counts, starts, write_blk, write_slot, pos,
                      *, attn_impl: str | None = None) -> torch.Tensor:
    """One decode iteration straight against the paged pool.

    tokens: (B, 1).  k_pages/v_pages: the ``PagedKVStore`` tensors,
    (L, n_blocks, block, KV, hd) — MUTATED IN PLACE: each layer writes the
    new token's K/V at (write_blk, write_slot), (B,) each, before its
    attention reads the pool.  tables/counts/starts: (B, n_slots) int32 run
    descriptors whose counts already include that token.  pos: (B,) int32
    sequence length including it.  Returns the (B, 1, V) f32 logits.
    """
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens)
    B = x.shape[0]
    windows = cfg.layer_windows()
    rope_pos = (pos - 1)[:, None]
    wb, ws = write_blk.long(), write_slot.long()
    for li in range(cfg.n_layers):
        p = _layer(params, li)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)                          # S == 1
        q = L.apply_rope(q, rope_pos, cfg.rope_theta)
        k = L.apply_rope(k, rope_pos, cfg.rope_theta)
        k_pages[li].index_put_((wb, ws), k[:, 0].to(k_pages.dtype))
        v_pages[li].index_put_((wb, ws), v[:, 0].to(v_pages.dtype))
        o = ops.paged_decode_attention(
            q[:, 0].contiguous(), k_pages, v_pages, tables, counts, starts,
            pos - 1, li, windows[li], logit_cap=cfg.attn_logit_softcap,
            impl=attn_impl)
        x = x + L.proj(o.reshape(B, 1, -1), p["wo"])
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h2)
    return lm_logits(cfg, params, x)


def paged_prefill_step(cfg: ModelConfig, params, tokens, k_pages, v_pages,
                       tables, counts, starts, q_start, q_len, write_blk,
                       write_slot, *,
                       attn_impl: str | None = None) -> torch.Tensor:
    """One ragged prefill chunk computed straight against the paged pool.

    tokens: (B, Sq) right-padded rows; row ``b`` holds ``q_len[b]`` valid
    tokens whose first sits at absolute position ``q_start[b]``.
    k_pages/v_pages: the pool tensors — MUTATED IN PLACE: each layer
    scatters the chunk's K/V at (write_blk, write_slot), (B, Sq) each,
    before attention (padding rows point at the store's scratch block,
    which no live run reads).  tables/counts/starts: (B, n_slots) run
    descriptors covering the cached prefix plus this chunk.  Returns the
    (B, 1, V) f32 logits at each row's last valid token.
    """
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens)
    B, Sq = tokens.shape
    windows = cfg.layer_windows()
    positions = q_start[:, None] + torch.arange(
        Sq, dtype=torch.int32, device=tokens.device)[None]
    wb, ws = write_blk.long(), write_slot.long()
    for li in range(cfg.n_layers):
        p = _layer(params, li)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)                          # (B, Sq, ., hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        k_pages[li].index_put_((wb, ws), k.to(k_pages.dtype))
        v_pages[li].index_put_((wb, ws), v.to(v_pages.dtype))
        # q is read in place through its strides; on the card o is a view
        # of a (B, Sq, H, hd) buffer, so neither side is copied
        o = ops.paged_prefill_attention(
            q.transpose(1, 2), k_pages, v_pages, tables, counts, starts,
            q_start, q_len, li, windows[li],
            logit_cap=cfg.attn_logit_softcap, impl=attn_impl)
        x = x + L.proj(o.transpose(1, 2).reshape(B, Sq, -1), p["wo"])
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h2)
    last = torch.clamp(q_len.long() - 1, 0, Sq - 1)
    x_last = torch.gather(x, 1, last[:, None, None].expand(B, 1, x.shape[-1]))
    return lm_logits(cfg, params, x_last)
