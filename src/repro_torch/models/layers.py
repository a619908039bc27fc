"""Building blocks of the dense, MoE and VLM families (counterpart of the
parts of ``repro.models.layers`` that the serving steps use).

Rounding points follow the JAX package: norms and RoPE compute in f32 and
cast back; ``dense`` rounds the matmul to the activation dtype, then adds
the bias in that dtype.  ``flash_attention`` (forward only) runs the
prefix-attention kernel; ``decode_attention`` is plain PyTorch, as the JAX
package's is plain jnp.

Row invariance.  On the card, cuBLAS chooses its GEMM kernel by the
number of rows in the call, and for some products that choice changes the
order in which a row's products are summed: the row's result then depends
on how many rows share the call, and a prefill cut into chunks would not
give the unchunked tokens.  ``proj`` runs those products through
``row_slabs``, in calls of exactly ``ROW_SLAB`` rows: one shape, one
kernel, the same bits for a row whatever else is in the batch.  Which
products need it was measured by chip_smoke.py's row-invariance probe
(calls of 1 to 8192 rows) on an H100 80GB HBM3 with torch 2.11 / CUDA
12.8, at each served model's widths (K deep, N wide):

  Qwen2-0.5B  the down projection (K 4864, N 896); not the K-896 ones
  Mistral-7B  the k and v projections (K 4096, N 1024) and the down
              projection (K 14336); not q, o (N 4096), gate, up (N 14336)
              or the logits (N 32000)
  LLaMA2-7B   the down projection (K 11008); not q, k, v, o, gate, up or
              the logits, all K 4096 with N >= 4096
  Mixtral-8x7B  k (K 4096, N 1024; v, of k's shape, showed no
              difference in its probe) and each expert's down projection
              (K 14336); not q, o, the experts' gate and up, the router
              (K 4096, N 8) or the logits.  The rule slabs the router
              too: a 512 x 4096 x 8 product.

Phi-3.5-MoE's gate and up (K 4096, N 6400) and down (K 6400) are not
measured on the card; the rule slabs only the down.

``slabbed`` holds that rule: deeper than SLAB_MIN_K, or SLAB_MIN_K deep
with at most a quarter as many outputs.  The norm's mean is row-invariant
as it is.  The probe runs every op with and without the helper, so a
product this rule misses shows there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30
# rows per call of the products run through row_slabs; 0 makes one call
# over all rows
ROW_SLAB = 512
# contraction depth of the products proj runs through row_slabs (slabbed)
SLAB_MIN_K = 4096


def row_slabs(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to the rows of ``x`` (..., K) in calls of exactly
    ROW_SLAB rows, the last slab zero-padded; ``fn`` maps (ROW_SLAB, K) to
    (ROW_SLAB, N) row by row.  Returns (..., N)."""
    if ROW_SLAB <= 0:
        return fn(x)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    if n % ROW_SLAB:
        rows = F.pad(rows, (0, 0, 0, ROW_SLAB - n % ROW_SLAB))
    parts = [fn(slab) for slab in rows.split(ROW_SLAB)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out[:n].reshape(*lead, out.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w).to(x.dtype)
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def slabbed(w: torch.Tensor) -> bool:
    """Whether ``proj`` runs the product with w (K, N) in fixed row slabs:
    K > SLAB_MIN_K, or K == SLAB_MIN_K and N <= K / 4 (see the module
    docstring)."""
    K, N = w.shape[-2], w.shape[-1]
    return K > SLAB_MIN_K or (K == SLAB_MIN_K and 4 * N <= K)


def proj(x: torch.Tensor, w: torch.Tensor,
         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dense(x, w, b)``, in fixed row slabs where ``slabbed(w)``."""
    if slabbed(w):
        return row_slabs(lambda r: dense(r, w, b), x)
    return dense(x, w, b)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    h = F.silu(proj(x, wg)) * proj(x, wu)
    return proj(h, wd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0, window: int = 0,
                    logit_cap: float = 0.0,
                    impl: str | None = None) -> torch.Tensor:
    """Causal attention of new tokens over [cached prefix ‖ new] KV, forward
    only.  q: (B, Sq, H, hd); k/v: (B, q_offset + Sq, KV, hd); query row i
    sits at absolute position q_offset + i.  Returns (B, Sq, H, hd)."""
    o = ops.prefix_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), prefix_len=int(q_offset),
                             window=int(window), logit_cap=logit_cap,
                             impl=impl)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: torch.Tensor,
                     window: int = 0, logit_cap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a dense cache.  q: (B, 1, H, hd);
    k/v_cache: (B, Smax, KV, hd); pos: (B,) cache length including the new
    token.  Scores are (B, H, Smax), linear in the context."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    R = H // KV
    qg = q.reshape(B, KV, R, hd).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float()) * hd ** -0.5
    if logit_cap:
        s = softcap(s, logit_cap)
    k_pos = torch.arange(Smax, device=q.device)[None]
    mask = k_pos < pos[:, None]
    if window > 0:
        mask &= k_pos > pos[:, None] - 1 - window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def stable_top_k(logits: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, largest first, the lower index
    first among equal values (``lax.top_k``'s order; ``torch.topk``
    promises none).  Returns (values, int64 indices)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """Top-``k`` routing: router logits (rounded to the activation dtype,
    then f32), their top ``k`` and the softmax of those in f32.  Returns
    (gates (..., k) f32, expert ids (..., k) int64)."""
    logits = proj(x, router_w).float()
    topv, topi = stable_top_k(logits, k)
    return torch.softmax(topv, dim=-1), topi


def moe_dense(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor,
              top_k: int) -> torch.Tensor:
    """Dense-compute MoE: every expert over every row, weighted by the
    top-k gates (zero for the experts a row did not pick).  The expert
    terms are summed in expert order in the activation dtype, each
    ``(y * gate.to(y.dtype)).to(acc_dt)`` as ``repro.models.layers``
    rounds them.  wg/wu (E, D, F), wd (E, F, D), router_w (D, E)."""
    E = router_w.shape[-1]
    gates, topi = route(x, router_w, top_k)
    w_full = torch.zeros(x.shape[:-1] + (E,), dtype=torch.float32,
                         device=x.device).scatter_(-1, topi, gates)
    acc = torch.zeros_like(x)
    for e in range(E):
        y = swiglu(x, wg[e], wu[e], wd[e])
        acc = acc + (y * w_full[..., e, None].to(y.dtype)).to(acc.dtype)
    return acc


def capacity_slots(topi: torch.Tensor, n_experts: int, cap: int):
    """Each (token, choice)'s slot in its expert's buffer, in token order,
    and whether it fits: topi (C, k) -> (one-hot (C, k, E) f32, slot
    (C, k, E) f32, -1 off the chosen expert, keep (C, k, E) bool)."""
    oh = F.one_hot(topi, n_experts).float()
    pos = torch.cumsum(oh.reshape(-1, n_experts), dim=0).reshape(oh.shape)
    pos = pos * oh - 1.0
    return oh, pos, (pos < cap) & (oh > 0)


def moe_capacity(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor, top_k: int, *,
                 capacity_factor: float = 1.25,
                 token_chunk: int = 4096) -> torch.Tensor:
    """Capacity-based dispatch MoE: per chunk of ``token_chunk`` tokens,
    one-hot dispatch into per-expert buffers of ``cap`` slots (tokens past
    an expert's capacity are dropped for that expert), each expert over
    its buffer only, and a gate-weighted one-hot combine; the dispatch and
    combine in f32, the expert products in the activation dtype."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    token_chunk = min(token_chunk, T)
    n_chunks = -(-T // token_chunk)
    xt = F.pad(x.reshape(T, D), (0, 0, 0, n_chunks * token_chunk - T))
    cap = max(int(capacity_factor * token_chunk * top_k / E), 1)
    slots = torch.arange(cap, device=x.device)
    out = []
    for xc in xt.split(token_chunk):
        gates, topi = route(xc, router_w, top_k)
        oh, pos, keep = capacity_slots(topi, E, cap)
        pos_oh = (pos.long()[..., None] == slots).float()
        disp = oh[..., None] * keep[..., None] * pos_oh         # (C,k,E,cap)
        xbuf = torch.einsum("ceC,cd->eCd", disp.sum(dim=1),
                            xc.float()).to(xc.dtype)
        h = F.silu(torch.einsum("eCd,edf->eCf", xbuf, wg))
        h = h * torch.einsum("eCd,edf->eCf", xbuf, wu)
        ybuf = torch.einsum("eCf,efd->eCd", h, wd)
        comb = (disp * gates[:, :, None, None]).sum(dim=1)      # (C,E,cap)
        yc = torch.einsum("ceC,eCd->cd", comb, ybuf.float())
        out.append(yc.to(xc.dtype))
    return torch.cat(out)[:T].reshape(B, S, D)
