"""Peaks, the kernels' least times, and the model FLOPs of a step.

Published peaks of one NVIDIA H100 SXM (dense, no sparsity), the rates the
shares below are taken against.  ``visible_pairs`` and ``bound_s`` are a
frozen copy of ``chip_smoke.py``'s ``visible_pairs`` / ``bound_ms``: the
least time of one attention launch is the larger of its inputs read once and
its output written once over the memory rate, and of the QK and PV products
of the (query, key) pairs its masks leave visible over the bf16 rate.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def visible_pairs(counts, starts, page: int, window: int, *, qpos=None,
                  q_start=None, q_len=None):
    """(query, key) pairs the masks leave visible, summed over rows, and the
    live key tokens the kernel must read.  Decode gives ``qpos`` (each
    row's position, the key it just wrote included); prefill ``q_start`` and
    ``q_len``.  Arrays are numpy, (B, n_slots) for the run tables."""
    slot = np.arange(page)
    live = slot[None, None] < counts[..., None]            # (B, n, page)
    kpos = starts[..., None] + slot[None, None]
    if qpos is not None:
        vis = live.copy()
        if window:
            vis &= kpos > qpos[:, None, None] - window
        pairs = int(vis.sum())
        return pairs, pairs
    pairs = keys = 0
    for b in range(counts.shape[0]):
        if q_len[b] == 0:
            continue
        kp = kpos[b][live[b]]
        qp = q_start[b] + np.arange(q_len[b])
        vis = kp[None] <= qp[:, None]
        if window:
            vis &= kp[None] > qp[:, None] - window
        pairs += int(vis.sum())
        seen = kp <= qp[-1]
        if window:
            seen &= kp > qp[0] - window
        keys += int(seen.sum())
    return pairs, keys


def bound_s(q_shape, q_bytes: int, KV: int, n_int: int, pairs: int,
            keys: int):
    """Least seconds of one launch and what bounds it ("bytes" or
    "operations").  q_shape (B, H, Sq, hd) (decode: (B, H, hd)); q_bytes
    the element size; n_int the int32 run-table entries read."""
    H, hd = q_shape[1], q_shape[-1]
    q_numel = int(np.prod(q_shape))
    byts = 2 * q_numel * q_bytes + 2 * keys * KV * hd * q_bytes + 4 * n_int
    flops = 4 * pairs * (H // KV) * KV * hd
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def active_matmul_params(cfg) -> int:
    """Parameters a token multiplies through, per token, embedding and
    logits left out: attention, and the FFN of the experts it is routed to
    (top-k of them, plus the router), whatever the implementation runs."""
    D, F, H, KV, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.moe_experts:
        ffn = cfg.moe_top_k * 3 * D * F + D * cfg.moe_experts
    else:
        ffn = 3 * D * F
    return cfg.n_layers * (attn + ffn)


def causal_pairs(q_start: int, n: int, window: int) -> int:
    """Visible (query, key) pairs of n new tokens at positions q_start ..
    q_start + n - 1 over the whole sequence before them (prefix reuse: the
    keys are positions 0 .. q_start + n - 1)."""
    p = np.arange(q_start, q_start + n, dtype=np.int64) + 1
    if window:
        p = np.minimum(p, window)
    return int(p.sum())


def prefill_flops(cfg, rows) -> float:
    """Model FLOPs of one prefill step over ``rows`` of (q_start, n) real
    tokens: 2 x active parameters a token computed, 4 hd H a visible pair in
    every layer, 2 D V a logits row."""
    windows = cfg.layer_windows()
    tokens = sum(n for _, n in rows)
    pairs = sum(causal_pairs(qs, n, w) for qs, n in rows for w in windows)
    return (2.0 * active_matmul_params(cfg) * tokens
            + 4.0 * cfg.hd * cfg.n_heads * pairs
            + 2.0 * cfg.d_model * cfg.vocab_size * len(rows))


def decode_flops(cfg, lengths) -> float:
    """Model FLOPs of one decode step over rows of the given sequence
    lengths (the new token included): 2 x active parameters and 2 D V a
    row, 4 hd H a visible pair in every layer."""
    pairs = sum(min(n, w) if w else n for n in lengths
                for w in cfg.layer_windows())
    return (len(lengths) * (2.0 * active_matmul_params(cfg)
                            + 2.0 * cfg.d_model * cfg.vocab_size)
            + 4.0 * cfg.hd * cfg.n_heads * pairs)
