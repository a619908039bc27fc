"""Building blocks of the model families (counterpart of the parts of
``repro.models.layers`` that the serving steps use).

Rounding points follow the JAX package: norms and RoPE compute in f32 and
cast back; ``dense`` rounds the matmul to the activation dtype, then adds
the bias in that dtype.  ``flash_attention`` runs the prefix-attention
kernel forward; under autograd its backward is ``flash_attention_bwd``,
plain PyTorch as the reference's custom VJP is plain jnp (the training
path).  ``decode_attention`` is plain PyTorch, as the JAX package's is
plain jnp.

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
  Gemma3-12B  the k and v projections (K 3840, N 2048), from 64 rows on;
              not q (N 4096), o (K 4096, N 3840), gate, up (N 15360) or
              the tied logits (N 262144).  Its down (K 15360) is deeper
              than SLAB_MIN_K, as every product of Gemma2-27B (K 4608 and
              up) and Yi-34B (K 7168 and up) but o (K 4096, N 4608 and
              7168) and Gemma2's tied logits, and none of those showed a
              difference with the rule applied.

  Phi-3.5-MoE  k and v (K 4096, N 1024, from 64 rows on) and each
              expert's gate and up (K 4096, N 6400, from 8 rows on); not
              q, o, the experts' down (K 6400, slabbed by depth), the
              router (N 16, slabbed as Mixtral's) or the logits (N 32064).
              No depth or width rule separates its gate and up from the
              invariant K-4096 products of the others (N 3840 to 32000),
              so SLAB_WIDTHS names them.

Where a tensor-parallel mesh's column products run in column slabs
(``col_proj``), the row rule is taken on each slab's (K, N / slabs).  scripts/probe_slab_rows.py,
over every such slab shape on the same card (rows 1 to 8192, bf16), found
these row-variant:
Mistral-7B's q slab (K 4096, N 1024) and k/v (N 256), LLaMA2-7B's gate and
up slabs (K 4096, N 2752), Gemma2-27B's q and k/v (K 4608), Yi-34B's q,
k/v and o (K 7168) and LLaMA2-70B's q and gate/up (K 8192), each row-
invariant in slabs of rows; Mistral-7B's gate and up slabs (K 4096, N
3584), Gemma3-12B's (K 3840, N 3840) and the tied logits' slabs of Qwen2-
0.5B (K 896), Gemma3-12B (K 3840) and Gemma2-27B (K 4608) were not.

``slabbed`` holds that rule: deeper than SLAB_MIN_K, the (K, N) of
SLAB_WIDTHS, or at least SLAB_NARROW_K deep with at most SLAB_NARROW_N
outputs (deep and narrow
products, for which cuBLAS splits the contraction across CTAs by a count
it picks from the rows; SLAB_NARROW_N sits between LLaMA2-7B's variant
gate/up slabs, N 2752, and Mistral-7B's invariant ones, N 3584; no
unslabbed product of a served model lies between 2048 and 3072 wide at
K >= 3840, so the rule slabs the same products a mesh of one slab runs as
it did at 2048).  Of the
products measured before Gemma3-12B the narrow clause adds only
xLSTM-1.3B's mLSTM down projection (K 4096, N 2048), which no probe has
measured.  The norm's mean is row-invariant as
it is.  The probe runs every op with and without the helper, so a
product this rule misses shows there.

The recurrent scans (``causal_conv1d``, ``mlstm_scan``,
``mlstm_chunkwise``, ``slstm_scan``, ``mamba_scan``) are plain PyTorch
loops over time in the reference's arithmetic order, their state in f32.
Each returns new state tensors and never writes the state it was given:
the knowledge tree holds those tensors as document snapshots.  Their f32
products run with TF32 off (``full_f32``), as the reference's f32 einsums
compute.  ``mlstm_chunkwise`` masks the chunk's upper triangle with a
select where the reference multiplies by the causal mask: past ~128 steps
a chunk's masked weights overflow to inf there, and inf x 0 made the
reference's outputs NaN (ROADMAP.md Queue C); wherever the reference is
finite the two agree.  The mask is applied to the weights' exponent as
well, so the backward does not meet that inf either.  Under autograd the
scans recompute chunk by chunk, as the reference's do: ``mlstm_chunkwise``
runs each chunk under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint(chunk_body)``), and ``slstm_scan`` and ``mamba_scan`` run
their steps through ``chunked_scan`` (the reference's, 256 steps a
chunk), so the backward keeps the carries at chunk boundaries and the
chunks' inputs, not every step's intermediates; ``mamba_scan`` then
computes a chunk's decay and input at once and its readout step by step.
Without autograd (serving) they run as one loop over all steps.  On fake
tensors (the compile analysis, ``launch/op_analysis.py``) ``slstm_scan``
and ``mamba_scan`` run a chunk's step ops once over its steps together
(``_slstm_shapes``, ``_mamba_shapes``), under the same checkpoints: the
same products with the same FLOPs, recompute included, the same output
shapes, in a handful of ops rather than a few per step; no value exists
there, so the recurrence's order is not needed.  ``row_slabs``
makes its slabs' products one call there too, and ``flash_attention_bwd``
runs one tile of each pass, counting the others' products
(``op_analysis.note``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.launch import op_analysis

NEG_INF = -1e30
# rows per call of the products run through row_slabs; 0 makes one call
# over all rows
ROW_SLAB = 512
# contraction depth of the products proj runs through row_slabs (slabbed),
# and the depth and width of the narrow ones it also runs through them
SLAB_MIN_K = 4096
SLAB_NARROW_K = 3840
SLAB_NARROW_N = 3072
# (K, N) of products measured row-variant that the depth rule misses
SLAB_WIDTHS = frozenset({(4096, 6400)})


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
    if op_analysis.is_fake(rows):
        # the compile analysis: the slabs' FLOPs in one call (their
        # weight counted once in the product bytes)
        out = fn(rows)
        return out[:n].reshape(*lead, out.shape[-1])
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
    # a factory, not torch.tensor: a fake-tensor run (the compile analysis)
    # must see every tensor the step makes
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
    K > SLAB_MIN_K, (K, N) in SLAB_WIDTHS, or K >= SLAB_NARROW_K and N <=
    SLAB_NARROW_N (see the module docstring)."""
    K, N = w.shape[-2], w.shape[-1]
    return (K > SLAB_MIN_K or (K, N) in SLAB_WIDTHS
            or (K >= SLAB_NARROW_K and N <= SLAB_NARROW_N))


def proj(x: torch.Tensor, w: torch.Tensor,
         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dense(x, w, b)``, in fixed row slabs where ``slabbed(w)``."""
    if slabbed(w):
        return row_slabs(lambda r: dense(r, w, b), x)
    return dense(x, w, b)


def col_proj(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None, slabs: int = 1) -> torch.Tensor:
    """``dense(x, w, b)`` computed in ``slabs`` column slabs: with
    ``slabs`` > 1, w is slab-major (slabs, K, N / slabs) and b (slabs,
    N / slabs) (``launch/sharding.py::placer``); each slab runs through
    ``proj`` (its row rule taken on the slab's shape), and the slabs'
    outputs are concatenated.

    Column invariance.  A product's column does not keep its bits when the
    call's width changes: cuBLAS, and the CPU's GEMMs, pick their kernel
    and split of the contraction by (M, N, K).
    scripts/probe_column_slices.py finds ``x @ w[:, shard]`` and
    ``(x @ w)[:, shard]`` differing on an H100 80GB HBM3 at Mistral-7B's
    q, k/v and gate widths in bf16 and at most widths in f32.  So a
    tensor-parallel mesh fixes a column-slab group G
    (``launch/mesh.py::ServingMesh.slabs``) and every mesh of that group
    runs each slab as the same call on the same contiguous operand: a
    shard's columns are a one-device mesh's bit for bit."""
    if slabs <= 1:
        return proj(x, w, b)
    return torch.cat([proj(x, w[j], None if b is None else b[j])
                      for j in range(slabs)], dim=-1)


def dense_rowsum(x_shards, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``proj`` for the row-parallel sites (wo, wd) of tensor-parallel
    serving (counterpart of ``repro.models.layers.dense_rowsum`` under
    ``tp_deterministic``): the shards' activations (a list, along the
    contraction dim, or one tensor) are gathered onto w's device first,
    and the contraction runs whole there, so its sum never crosses
    devices and its bits are tp 1's."""
    if isinstance(x_shards, torch.Tensor):
        return proj(x_shards.to(w.device), w, b)
    x = torch.cat([t.to(w.device) for t in x_shards], dim=-1)
    return proj(x, w, b)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    h = F.silu(proj(x, wg)) * proj(x, wu)
    return proj(h, wd)


FLASH_CHUNK = 512    # q and kv chunk of the backward (the reference's)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0, window: int = 0,
                    logit_cap: float = 0.0,
                    impl: str | None = None) -> torch.Tensor:
    """Causal attention of new tokens over [cached prefix ‖ new] KV.  q:
    (B, Sq, H, hd); k/v: (B, q_offset + Sq, KV, hd); query row i sits at
    absolute position q_offset + i.  Returns (B, Sq, H, hd).

    The forward is the prefix-attention dispatch (the CUDA kernel on the
    card).  When autograd records (grad mode on and an input requiring
    grad) it runs inside ``_FlashAttention``, whose backward is
    ``flash_attention_bwd``; otherwise the dispatch is called as is."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, int(q_offset), int(window),
                                     float(logit_cap), impl)
    return _prefix_attention(q, k, v, q_offset, window, logit_cap, impl)


SEQPAR_CHUNK = 512   # query chunk of the sequence-parallel prefill


def flash_attention_seqpar(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, q_offset: int = 0,
                           window: int = 0, logit_cap: float = 0.0,
                           devices=None,
                           impl: str | None = None) -> torch.Tensor:
    """Forward-only prefill attention with the query chunks dealt over
    ``devices`` (counterpart of ``repro.models.layers.
    flash_attention_seqpar``, the compile analysis's ``seq-par``): chunk
    j of SEQPAR_CHUNK rows runs on ``devices[j % len(devices)]`` through
    the prefix-attention dispatch, over the keys ``[0, q_offset +
    chunk end)`` with ``prefix_len = q_offset + chunk start``; the whole
    KV is copied once to each device, and the outputs come back to q's
    device in order.  q (B, Sq, H, hd); k/v (B, q_offset + Sq, KV, hd).
    Chunk starts are multiples of the kernel's key tile, so on the card
    each row's bits are the unsplit call's."""
    devices = list(devices or [q.device])
    Sq = q.shape[1]
    kv = {d: (k.to(d), v.to(d)) for d in dict.fromkeys(devices)}
    outs = []
    for j, c0 in enumerate(range(0, Sq, SEQPAR_CHUNK)):
        c1 = min(c0 + SEQPAR_CHUNK, Sq)
        dev = devices[j % len(devices)]
        kd, vd = kv[dev]
        end = q_offset + c1
        o = _prefix_attention(q[:, c0:c1].to(dev), kd[:, :end], vd[:, :end],
                              q_offset + c0, window, logit_cap, impl)
        outs.append(o.to(q.device))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _prefix_attention(q, k, v, q_offset, window, logit_cap, impl):
    o = ops.prefix_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), prefix_len=int(q_offset),
                             window=int(window), logit_cap=logit_cap,
                             impl=impl)
    return o.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """The prefix-attention dispatch forward, ``flash_attention_bwd``
    backward (the reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, window, logit_cap, impl):
        o = _prefix_attention(q, k, v, q_offset, window, logit_cap, impl)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (q_offset, window, logit_cap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        q_offset, window, logit_cap = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, q_offset=q_offset,
                                         window=window, logit_cap=logit_cap)
        return dq, dk, dv, None, None, None, None


def _chunk_mask(q_pos, k_pos, window: int):
    """(Cq, Ckv) bool: causal, and with a window only keys at positions >
    q_pos - window (the reference's ``_chunk_mask``; keys are unpadded)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _chunk_scores(qi, ki, scale, logit_cap):
    """(B, KV, R, Cq, Ckv) f32 scores of grouped qi (B, Cq, KV, R, hd) over
    ki (B, Ckv, KV, hd), softcapped; and the softcap's derivative (None
    without a cap)."""
    u = torch.einsum("bqgrd,bkgd->bgrqk", qi, ki) * scale
    if not logit_cap:
        return u, None
    s = softcap(u, logit_cap)
    return s, 1.0 - torch.square(s / logit_cap)


def flash_attention_bwd(q, k, v, o, do, *, q_offset: int = 0,
                        window: int = 0, logit_cap: float = 0.0):
    """The gradients (dq, dk, dv) of ``flash_attention`` at output ``o``
    for the output gradient ``do``: the reference's ``_flash_vjp_bwd`` in
    plain PyTorch, chunk by chunk (FLASH_CHUNK x FLASH_CHUNK score tiles), in
    f32 with TF32 off.  The reference reads the row logsumexp its forward
    saved; the prefix kernel writes none, so a first pass recomputes it
    from q and k chunk by chunk (online max and sum, ``m + log(max(l,
    1e-30))``).  Tiles that the causal mask and the window hide wholly are
    skipped: they add exact zeros in the reference.  q, o, do: (B, Sq, H,
    hd); k, v: (B, q_offset + Sq, KV, hd); the gradients come back in the
    inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    R = H // KV
    scale = hd ** -0.5
    chunk = FLASH_CHUNK
    with full_f32():
        qg = q.float().reshape(B, Sq, KV, R, hd)
        dog = do.float().reshape(B, Sq, KV, R, hd)
        kf, vf = k.float(), v.float()
        Dg = (dog * o.float().reshape(B, Sq, KV, R, hd)).sum(-1)
        dq = torch.zeros_like(qg)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        q_chunks = range(0, Sq, chunk)
        k_chunks = range(0, Skv, chunk)

        def pos(lo, n, off=0):
            return off + torch.arange(lo, min(lo + chunk, n), device=q.device)

        def visible(q0, k0):
            qp0, qp1 = q_offset + q0, q_offset + min(q0 + chunk, Sq) - 1
            kp1 = min(k0 + chunk, Skv) - 1
            return k0 <= qp1 and (window <= 0 or kp1 > qp0 - window)

        # on fake tensors (the compile analysis) one visible tile of each
        # pass runs; every other one is counted at its products' FLOPs and
        # bytes (op_analysis.note): the same FLOPs, one tile's transients
        fake = op_analysis.is_fake(q)
        ran = set()

        def stand_in(q0, k0, n_products, which):
            if not fake or which not in ran:
                ran.add(which)
                return False
            cq, ck = min(q0 + chunk, Sq) - q0, min(k0 + chunk, Skv) - k0
            tile = B * H * cq * ck
            op_analysis.note(q.device, n_products * 2 * tile * hd,
                             4 * n_products * (tile + B * (cq * H + ck * KV)
                                               * hd))
            return True

        lse = []
        for q0 in q_chunks:
            qi = qg[:, q0:q0 + chunk]
            qp = pos(q0, Sq, q_offset)
            m = torch.full((B, KV, R, qi.shape[1]), NEG_INF, device=q.device)
            lsum = torch.zeros_like(m)
            for k0 in k_chunks:
                if not visible(q0, k0) or stand_in(q0, k0, 1, "lse"):
                    continue
                s, _ = _chunk_scores(qi, kf[:, k0:k0 + chunk], scale,
                                     logit_cap)
                s = torch.where(_chunk_mask(qp, pos(k0, Skv), window), s,
                                NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                lsum = lsum * torch.exp(m - m_new) \
                    + torch.exp(s - m_new[..., None]).sum(-1)
                m = m_new
            lse.append(m + torch.log(torch.clamp(lsum, min=1e-30)))
        for k0 in k_chunks:
            ki, vi = kf[:, k0:k0 + chunk], vf[:, k0:k0 + chunk]
            kp = pos(k0, Skv)
            for qc, q0 in enumerate(q_chunks):
                if not visible(q0, k0) or stand_in(q0, k0, 5, "grads"):
                    continue
                sl = slice(q0, q0 + chunk)
                qi, doi = qg[:, sl], dog[:, sl]
                s, dcap = _chunk_scores(qi, ki, scale, logit_cap)
                mask = _chunk_mask(pos(q0, Sq, q_offset), kp, window)
                p = torch.where(mask, torch.exp(s - lse[qc][..., None]), 0.0)
                dv[:, k0:k0 + chunk] += torch.einsum("bgrqk,bqgrd->bkgd", p,
                                                     doi)
                dp = torch.einsum("bqgrd,bkgd->bgrqk", doi, vi)
                ds = p * (dp - Dg[:, sl].permute(0, 2, 3, 1)[..., None])
                if dcap is not None:
                    ds = ds * dcap
                dq[:, sl] += torch.einsum("bgrqk,bkgd->bqgrd", ds, ki) \
                    * scale
                dk[:, k0:k0 + chunk] += torch.einsum("bgrqk,bqgrd->bkgd",
                                                     ds, qi) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: torch.Tensor,
                     window: int = 0, logit_cap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a dense cache.  q: (B, 1, H, hd);
    k/v_cache: (B, Smax, KV, hd); pos: (B,) cache length including the new
    token.  Scores are (B, H, Smax), linear in the context."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = decode_scores(torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float()),
                      pos, hd, window=window, logit_cap=logit_cap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_scores(s: torch.Tensor, pos: torch.Tensor, hd: int, *,
                  offset: int = 0, window: int = 0,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """``decode_attention``'s scores from the raw products q . k (B, KV,
    R, S) f32 of the cache positions ``[offset, offset + S)``: scaled,
    softcapped, and NEG_INF where a key is at or past ``pos`` or before
    the window, in that order."""
    s = s * hd ** -0.5
    if logit_cap:
        s = softcap(s, logit_cap)
    k_pos = torch.arange(s.shape[-1], device=s.device)[None]
    if offset:
        k_pos = k_pos + offset
    mask = k_pos < pos[:, None]
    if window > 0:
        mask &= k_pos > pos[:, None] - 1 - window
    return torch.where(mask[:, None, None], s, NEG_INF)


def decode_partial(s: torch.Tensor):
    """One slice's softmax statistics of ``decode_scores``' ``s``: (m, e,
    l), each row's largest score, exp(s - m) and its sum.  A slice with no
    visible key gives m = NEG_INF, which ``merge_partials`` weighs by
    exactly 0 beside a slice that has one."""
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    return m, e, e.sum(-1)


def merge_partials(parts, device) -> torch.Tensor:
    """The attention output (B, KV, R, hd) f32 of the slices' partials
    ``(m, l, o)`` (o = e . V unnormalised), merged on ``device`` in the
    given order from m = NEG_INF, l = o = 0; each partial's copy there is
    tallied as an all-reduce."""
    m = l = o = None
    for pm, pl, po in parts:
        pm, pl, po = (op_analysis.to(t, device, "all-reduce")
                      for t in (pm, pl, po))
        if m is None:
            m = torch.full_like(pm, NEG_INF)
            l, o = torch.zeros_like(pl), torch.zeros_like(po)
        new = torch.maximum(m, pm)
        a, b = torch.exp(m - new), torch.exp(pm - new)
        l = l * a + pl * b
        o = o * a[..., None] + po * b[..., None]
        m = new
    return o / l[..., None]


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
    return route_logits(proj(x, router_w), k)


def route_logits(logits: torch.Tensor, k: int):
    """``route`` from the router's logits (..., E) in the activation dtype
    (a tensor-parallel mesh gathers them from its shards' columns)."""
    topv, topi = stable_top_k(logits.float(), k)
    return torch.softmax(topv, dim=-1), topi


def moe_dense(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor,
              top_k: int) -> torch.Tensor:
    """Dense-compute MoE: every expert over every row, weighted by the
    top-k gates (zero for the experts a row did not pick).  The expert
    terms are summed in expert order in the activation dtype, each
    ``(y * gate.to(y.dtype)).to(acc_dt)`` as ``repro.models.layers``
    rounds them.  wg/wu (E, D, F), wd (E, F, D), router_w (D, E)."""
    return moe_dense_with(x, route(x, router_w, top_k),
                          lambda e: swiglu(x, wg[e], wu[e], wd[e]),
                          router_w.shape[-1])


def moe_dense_with(x: torch.Tensor, routed, expert,
                   n_experts: int) -> torch.Tensor:
    """``moe_dense`` from ``routed``, the rows' (gates, expert ids) as
    ``route`` gives them, and ``expert(e)``, expert e's output (..., D)
    over every row of ``x``, on x's device: the form a tensor-parallel
    mesh computes with its shards' products.  The combine runs here, in
    expert order, with ``moe_dense``'s rounding."""
    E = n_experts
    gates, topi = routed
    w_full = torch.zeros(x.shape[:-1] + (E,), dtype=torch.float32,
                         device=x.device).scatter_(-1, topi, gates)
    acc = torch.zeros_like(x)
    for e in range(E):
        y = expert(e)
        acc = acc + (y * w_full[..., e, None].to(y.dtype)).to(acc.dtype)
    return acc


def capacity_slots(topi: torch.Tensor, n_experts: int, cap: int,
                   before=None):
    """Each (token, choice)'s slot in its expert's buffer, in token order,
    and whether it fits: topi (C, k) -> (one-hot (C, k, E) f32, slot
    (C, k, E) f32, -1 off the chosen expert, keep (C, k, E) bool).
    ``before(counts)``: the picks of each expert by tokens ahead of these
    (E,) f32, given these tokens' own counts; their slots follow those."""
    oh = F.one_hot(topi, n_experts).float()
    pos = torch.cumsum(oh.reshape(-1, n_experts), dim=0).reshape(oh.shape)
    if before is not None:
        pos = pos + before(oh.sum(dim=(0, 1)))
    pos = pos * oh - 1.0
    return oh, pos, (pos < cap) & (oh > 0)


def glu_buffers(xbuf: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor) -> torch.Tensor:
    """The experts' gated activations over their buffers: xbuf (E, C, D),
    wg/wu (E, D, F) -> (E, C, F), products batched over E."""
    h = F.silu(torch.einsum("eCd,edf->eCf", xbuf, wg))
    return h * torch.einsum("eCd,edf->eCf", xbuf, wu)


def moe_capacity(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor, top_k: int, *,
                 capacity_factor: float = 1.25,
                 token_chunk: int = 4096) -> torch.Tensor:
    """Capacity-based dispatch MoE: per chunk of ``token_chunk`` tokens,
    one-hot dispatch into per-expert buffers of ``cap`` slots (tokens past
    an expert's capacity are dropped for that expert), each expert over
    its buffer only, and a gate-weighted one-hot combine; the dispatch and
    combine in f32, the expert products in the activation dtype."""
    return moe_capacity_with(
        x, lambda xc: route(xc, router_w, top_k),
        lambda xbuf: torch.einsum("eCf,efd->eCd",
                                  glu_buffers(xbuf, wg, wu), wd),
        router_w.shape[-1], top_k, capacity_factor=capacity_factor,
        token_chunk=token_chunk)


def moe_capacity_with(x: torch.Tensor, route_fn, experts_fn, n_experts: int,
                      top_k: int, *, capacity_factor: float = 1.25,
                      token_chunk: int = 4096, place=None) -> torch.Tensor:
    """``moe_capacity`` from ``route_fn(xc)``, a chunk's rows' (gates,
    expert ids) as ``route`` gives them, and ``experts_fn(xbuf)``,
    the experts' outputs (E, cap, D) over their buffers (E, cap, D): the
    form a tensor-parallel mesh computes with its shards' products.  The
    dispatch and the combine run here.

    ``place``: (first, total, before) when ``x`` holds the tokens
    ``[first, first + B S)`` of a batch of ``total`` tokens split over
    data replicas (``models/model.py::CapacityDispatch``): the chunks are
    the whole batch's, and each part of one here fills that chunk's
    buffers at the slots ``before(chunk, counts)`` leaves it (the picks of
    the chunk's earlier tokens); the buffer holds only this part's
    rows."""
    B, S, D = x.shape
    E = n_experts
    T = B * S
    first, total, before = (0, T, None) if place is None else place
    token_chunk = min(token_chunk, total)
    cap = max(int(capacity_factor * token_chunk * top_k / E), 1)
    slots = torch.arange(cap, device=x.device)
    xt = x.reshape(T, D)
    if place is None:
        n_chunks = -(-T // token_chunk)
        xt = F.pad(xt, (0, 0, 0, n_chunks * token_chunk - T))
        parts = list(enumerate(xt.split(token_chunk)))
    else:
        parts, lo = [], first
        while lo < first + T:
            c = lo // token_chunk
            hi = min((c + 1) * token_chunk, first + T)
            parts.append((c, xt[lo - first:hi - first]))
            lo = hi
    out = []
    for c, xc in parts:
        gates, topi = route_fn(xc)
        oh, pos, keep = capacity_slots(
            topi, E, cap, None if before is None
            else functools.partial(before, c))
        pos_oh = (pos.long()[..., None] == slots).float()
        disp = oh[..., None] * keep[..., None] * pos_oh         # (C,k,E,cap)
        xbuf = torch.einsum("ceC,cd->eCd", disp.sum(dim=1),
                            xc.float()).to(xc.dtype)
        ybuf = experts_fn(xbuf)
        comb = (disp * gates[:, :, None, None]).sum(dim=1)      # (C,E,cap)
        yc = torch.einsum("ceC,eCd->cd", comb, ybuf.float())
        out.append(yc.to(xc.dtype))
    return torch.cat(out)[:T].reshape(B, S, D)


# ---------------------------------------------------------------------------
# recurrent families: xLSTM (mLSTM + sLSTM) and Hymba's SSM heads
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_f32():
    """f32 matrix products at full f32 precision for the duration: TF32,
    which would round their inputs to 10 mantissa bits on the card, is
    turned off and restored after.  The reference's scans are f32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-f)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Causal depthwise conv.  x: (B, S, D), w: (K, D); ``state`` carries
    the last K-1 inputs.  Returns (y, new_state)."""
    K = w.shape[0]
    if K == 1:
        return x * w[0], state
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xc = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xc[:, i:i + S] * w[i]
    return y.to(x.dtype), xc[:, -(K - 1):]


def mlstm_init(B: int, H: int, hd: int, device=None):
    """Fresh mLSTM state (C (B, H, hd, hd), n (B, H, hd), m (B, H)), f32."""
    return (torch.zeros((B, H, hd, hd), device=device),
            torch.zeros((B, H, hd), device=device),
            torch.full((B, H), NEG_INF, device=device))


@full_f32()
def mlstm_scan(q, k, v, i_gate, f_gate, state=None):
    """Strictly recurrent mLSTM (matrix memory, stabilised exp gating), one
    step at a time: the S == 1 decode form and the chunkwise form's oracle.
    q/k/v (B, S, H, hd), gates (B, S, H).  Returns (h, (C, n, m))."""
    B, S, H, hd = q.shape
    C, n, m = state if state is not None else mlstm_init(B, H, hd, q.device)
    qs, vs = q.float(), v.float()
    ks = k.float() * hd ** -0.5
    igs, fgs = i_gate.float(), f_gate.float()
    hs = []
    for t in range(S):
        qt, kt, vt = qs[:, t], ks[:, t], vs[:, t]
        i_sc, f_sc, m_new = mlstm_gates(igs[:, t], fgs[:, t], m)
        C, n = mlstm_write(C, n, vt, kt, kt, i_sc, f_sc)
        num = torch.einsum("bhij,bhj->bhi", C, qt)
        den = torch.abs(torch.einsum("bhj,bhj->bh", n, qt))
        hs.append(num / mlstm_divisor(den, m_new)[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def mlstm_gates(ig, fg, m):
    """One mLSTM step's stabilised gates from its f32 input and forget
    pre-activations (B, H) and the state's m: (i_sc, f_sc, m_new)."""
    log_f = _log_sigmoid(fg)
    m_new = torch.maximum(log_f + m, ig)
    return torch.exp(ig - m_new), torch.exp(log_f + m - m_new), m_new


def mlstm_write(C, n, v, k, k_n, i_sc, f_sc):
    """One mLSTM step's state update: f C + i v k^T (C's rows are v's:
    ``v`` the whole (B, H, hd) or the slice a shard's rows hold, ``k``
    whole) and f n + i ``k_n`` (k, or the slice of it n's part holds)."""
    C = f_sc[..., None, None] * C + i_sc[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_sc[..., None] * n + i_sc[..., None] * k_n
    return C, n


def mlstm_divisor(den, m):
    """h's divisor from |n . q| and the step's m: max(den, exp(-m)), the
    floor's exponent clamped at 30."""
    return torch.maximum(den, torch.exp(torch.clamp(-m, max=30.0)))


def _records(*tensors) -> bool:
    """Whether autograd records ops on any of ``tensors`` here."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def chunked_scan(f, carry, xs, chunk: int = 256):
    """The reference's ``chunked_scan`` with ``remat`` (its callers'
    setting): a scan over time in chunks of ``chunk`` steps, each chunk
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``),
    so that the backward keeps only the carries at chunk boundaries and the
    chunks' inputs and recomputes a chunk's steps when it reaches them.
    ``f(carry, *xs_c)`` runs the steps of one chunk ``xs_c`` (time on dim
    1 of each of ``xs``) and returns (carry, ys), ys with time on dim 1.  A
    last chunk shorter than ``chunk`` runs as it is: the reference pads it
    with masked steps, which leave the same carries.  S <= chunk: ``f``
    over all steps, as the reference's plain scan."""
    S = xs[0].shape[1]
    if S <= chunk:
        return f(carry, *xs)
    body = functools.partial(checkpoint, f, use_reentrant=False)
    ys = []
    for c0 in range(0, S, chunk):
        carry, y = body(carry, *(x[:, c0:c0 + chunk] for x in xs))
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


@full_f32()
def mlstm_chunkwise(q, k, v, i_gate, f_gate, state=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM: within a chunk (C x C) and (C x hd)
    products, across chunks only the (hd x hd) state.  Equal to
    ``mlstm_scan`` up to f32 association.  Time is padded to whole chunks
    with steps that neither write (i = NEG_INF) nor decay (f = 80).  Under
    autograd each chunk runs under ``torch.utils.checkpoint``, as the
    reference's ``lax.scan(jax.checkpoint(chunk_body))``: the backward
    keeps the states at chunk boundaries and the chunks' inputs, not a
    chunk's scores and products."""
    B, S, H, hd = q.shape
    carry = (state if state is not None
             else mlstm_init(B, H, hd, q.device))
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def padt(x, value=0.0):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value)

    qf, vf = padt(q.float()), padt(v.float())
    kf = padt(k.float()) * hd ** -0.5
    ig = padt(i_gate.float(), NEG_INF)
    fg = padt(f_gate.float(), 80.0)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    body = functools.partial(_mlstm_chunk, causal=causal)
    if _records(q, k, v, i_gate, f_gate, *carry):
        body = functools.partial(checkpoint, body, use_reentrant=False)
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry, h = body(carry, qf[:, sl], kf[:, sl], vf[:, sl], ig[:, sl],
                        fg[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :S]
    return h.to(q.dtype), carry


@full_f32()
def _mlstm_chunk(carry, qi, ki, vi, ii, fi, *, causal):
    """One chunk of ``mlstm_chunkwise``: its f32 inputs (B, C, H, ...)
    (k scaled) and the state (C, n, m) at its start give (the state at its
    end, h (B, C, H, hd) f32)."""
    C_in, n_in, m_in = carry
    lf = _log_sigmoid(fi)                                  # (B, C, H)
    Fc = torch.cumsum(lf, dim=1)
    g = ii - Fc
    Mt = torch.maximum(m_in[:, None], torch.cummax(g, dim=1).values)
    m_t = Fc + Mt
    in_scale = torch.exp(m_in[:, None] - Mt)               # (B, C, H)
    # intra-chunk scores A[t, s] = (q_t . k_s) exp(g_s - M_t), s <= t
    qk = torch.einsum("bthd,bshd->bhts", qi, ki)
    # the exponent is masked before exp: past ~128 steps the upper
    # triangle's exp overflows to inf, and a select after it would pass
    # its backward 0 x inf = NaN (the causal entries keep their bits)
    wts = torch.exp(torch.where(
        causal, g.transpose(1, 2)[:, :, None, :]
        - Mt.transpose(1, 2)[:, :, :, None], NEG_INF))
    A = torch.where(causal, qk * wts, 0.0)
    Cq = torch.einsum("bhij,bthj->bthi", C_in, qi)
    num = in_scale[..., None] * Cq + torch.einsum("bhts,bshd->bthd", A, vi)
    nq = torch.einsum("bhj,bthj->bth", n_in, qi)
    den = in_scale * nq + A.sum(dim=-1).transpose(1, 2)
    floor = torch.exp(torch.clamp(-m_t, max=30.0))
    h = num / torch.maximum(torch.abs(den), floor)[..., None]
    # the state at the chunk's end
    MT = Mt[:, -1]                                         # (B, H)
    state_scale = torch.exp(m_in - MT)
    wk = torch.exp(g - MT[:, None])                        # (B, C, H)
    C_out = state_scale[..., None, None] * C_in + torch.einsum(
        "bshd,bsh,bshe->bhde", vi, wk, ki)
    n_out = state_scale[..., None] * n_in + torch.einsum(
        "bsh,bshd->bhd", wk, ki)
    return (C_out, n_out, Fc[:, -1] + MT), h


def slstm_init(B: int, H: int, hd: int, device=None):
    """Fresh sLSTM state (c, n, h, m), each (B, H, hd) f32; n starts at
    1."""
    z = torch.zeros((B, H, hd), device=device)
    return (z, torch.ones_like(z), z.clone(), z.clone())


@full_f32()
def slstm_scan(zifo, r_w, state=None, chunk: int = 256):
    """sLSTM: scalar memory, block-diagonal recurrence, exp gating, one step
    at a time.  zifo: (B, S, H, 4 hd) input pre-activations; r_w (H, hd,
    4 hd).  Under autograd the steps run through ``chunked_scan`` in
    chunks of ``chunk``, as the reference's.  Returns (h (B, S, H, hd),
    (c, n, h, m))."""
    B, S, H, hd4 = zifo.shape
    state = (state if state is not None
             else slstm_init(B, H, hd4 // 4, zifo.device))
    steps = functools.partial(_slstm_steps, rw=r_w.float())
    if _records(zifo, r_w, *state):
        state, hs = chunked_scan(steps, state, (zifo.float(),), chunk)
    else:
        state, hs = steps(state, zifo.float())
    return hs.to(zifo.dtype), state


@full_f32()
def _slstm_steps(state, xs, rw):
    """``slstm_scan``'s steps over f32 ``xs`` (B, S, H, 4 hd) from
    ``state``: (the last state, h (B, S, H, hd) f32)."""
    if op_analysis.is_fake(xs):
        return _slstm_shapes(xs, rw, state)
    c, n, h, m = state
    hs = []
    for t in range(xs.shape[1]):
        rec = torch.einsum("bhi,hio->bho", h, rw)
        c, n, h, m = slstm_cell(*(xs[:, t] + rec).chunk(4, dim=-1), c, n, m)
        hs.append(h)
    return (c, n, h, m), torch.stack(hs, dim=1)


def slstm_cell(z, i, f, o, c, n, m):
    """One sLSTM step, elementwise: the f32 pre-activations (the input's
    and the recurrence's summed) and the state's c, n, m give the new (c,
    n, h, m)."""
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = _log_sigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    i_sc = torch.exp(i - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c = f_sc * c + i_sc * z
    n = f_sc * n + i_sc
    return c, n, o * c / torch.clamp(n, min=1.0), m_new


def _slstm_shapes(xs, rw, state):
    """``_slstm_steps`` on fake tensors: the recurrent products of every
    step at once, the gates over every step; the loop's output shapes and
    dtypes.  The first step's product reads the given state and the
    others a stand-in for the previous steps' outputs (derived from
    ``xs``, so autograd carries it as the loop's), so the products'
    FLOPs forward and backward are the loop's."""
    c, n, h, m = state
    hd = h.shape[-1]
    prev = torch.tanh(xs[:, :-1, :, :hd])
    rec = torch.cat([torch.einsum("bhi,hio->bho", h, rw)[:, None],
                     torch.einsum("bshi,hio->bsho", prev, rw)], dim=1)
    z, i, f, o = (xs + rec).chunk(4, dim=-1)
    log_f = _log_sigmoid(f)
    m_new = torch.maximum(log_f + m[:, None], i)
    c = torch.exp(log_f - m_new) * c[:, None] + torch.exp(i - m_new) \
        * torch.tanh(z)
    n = torch.exp(log_f - m_new) * n[:, None] + torch.exp(i - m_new)
    hs = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return (c[:, -1], n[:, -1], hs[:, -1], m_new[:, -1]), hs


def _mamba_shapes(decay, inp, Cs, D, xs):
    """``mamba_scan``'s states on fake tensors: one elementwise op over
    every step (the loop's ops are elementwise: no FLOPs are lost), then
    the readout as the loop's.  Returns (y f32, the last state)."""
    hs = decay * inp
    y = torch.einsum("sbhdn,bsn->bshd", hs, Cs) + D.float() * xs
    return y, hs[-1].clone()


@full_f32()
def mamba_scan(x, delta, A, Bm, Cm, D, state=None, chunk: int = 256):
    """Selective SSM: h_t = exp(delta_t A) h_{t-1} + delta_t (B_t (x) x_t),
    y_t = C_t . h_t + D x_t.  x (B, S, H, hd), delta (B, S, H), A (H, hd,
    N), Bm/Cm (B, S, N), D (H, hd); state (B, H, hd, N) f32, the Hymba
    document snapshot.  Under autograd the steps run through
    ``chunked_scan`` in chunks of ``chunk`` (``_mamba_steps``), as the
    reference's.  Without it the step's decay and input are computed for
    every step at once and the readout after the loop, elementwise as the
    reference computes them per step.  Returns (y, new_state)."""
    Bb, S, H, hd = x.shape
    N = A.shape[-1]
    h = (state if state is not None
         else torch.zeros((Bb, H, hd, N), device=x.device))
    xs, ds = x.float(), delta.float()
    Bs, Cs = Bm.float(), Cm.float()
    if _records(x, delta, A, Bm, Cm, D, h):
        steps = functools.partial(_mamba_steps, A=A.float(), D=D.float())
        h, y = chunked_scan(steps, h, (xs, ds, Bs, Cs), chunk)
        return y.to(x.dtype), h
    decay, inp = _mamba_terms(xs, ds, Bs, A.float())
    if op_analysis.is_fake(x):
        y, h = _mamba_shapes(decay, inp + h, Cs, D, xs)
        return y.to(x.dtype), h
    hs = torch.empty_like(decay)
    for t in range(S):
        h = torch.mul(decay[t], h, out=hs[t])
        h += inp[t]
    y = torch.einsum("sbhdn,bsn->bshd", hs, Cs) + D.float() * xs
    # a copy: the last step's view would keep every step's state alive
    return y.to(x.dtype), h.clone()


def _mamba_terms(xs, ds, Bs, A):
    """The steps' decay exp(delta A) and input delta (B (x) x) from f32
    x (B, S, H, hd), delta (B, S, H), B (B, S, N) and A (H, hd, N), time-
    major (S, B, H, hd, N)."""
    decay = torch.exp(ds.transpose(0, 1)[..., None, None] * A)
    inp = (ds[..., None] * xs).transpose(0, 1)[..., None] \
        * Bs.transpose(0, 1)[:, :, None, None, :]
    return decay, inp


@full_f32()
def _mamba_steps(h, xs, ds, Bs, Cs, A, D):
    """A chunk of ``mamba_scan``'s steps under autograd, f32 inputs with
    time on dim 1: the chunk's decay and input at once, then per step the
    state and its readout C_t . h_t + D x_t, as the reference's step.
    Returns (the last state, y (B, C, H, hd) f32)."""
    decay, inp = _mamba_terms(xs, ds, Bs, A)
    if op_analysis.is_fake(xs):
        y, h = _mamba_shapes(decay, inp + h, Cs, D, xs)
        return h, y
    ys = []
    for t in range(xs.shape[1]):
        h = decay[t] * h + inp[t]
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cs[:, t]) + D * xs[:, t])
    return h, torch.stack(ys, dim=1)
