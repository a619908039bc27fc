"""Prefix-cached prefill attention over dense ``[prefix ‖ new]`` KV
(counterpart of ``repro.kernels.prefix_attention``).

Queries of the ``Sq`` new tokens attend over the concatenation of the
cached prefix KV and their own KV, ``Skv = prefix_len + Sq`` keys: query
row ``i`` sits at absolute position ``prefix_len + i``, sees keys at
positions ``<= prefix_len + i`` and, with a window ``w > 0``, only keys at
positions ``> prefix_len + i - w``.  GQA maps head ``h`` to KV head
``h // (H // KV)``.  This is the attention of the model's dense prefill
(``models.model.prefill``): the CAG corpus preload, ``--attn dense`` and
the sequential engine.

Layouts: q ``(B, H, Sq, hd)``, k/v ``(B, KV, Skv, hd)``, any strides with a
contiguous last dimension.  ``prefix_flash_attention`` wraps the
hand-written CUDA kernel (``csrc/prefix_attention.cu``) and returns a
``(B, H, Sq, hd)`` view of a ``(B, Sq, H, hd)`` buffer, so the model's
``(B, S, heads, hd)`` layout goes in and comes out without a copy.
``prefix_attention_torch`` is its plain PyTorch version, which the wrapper
runs for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import HEAD_DIMS, MAX_R, check_rows

NEG_INF = -1e30
BLOCK = 128         # block_q = block_k of the TPU kernel


def _check_shapes(q, k, v, prefix_len: int) -> None:
    B, H, Sq, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, KV, Skv, hd) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    KV, Skv = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if Skv != prefix_len + Sq:
        raise ValueError(f"Skv {Skv} != prefix_len {prefix_len} + Sq {Sq}")


def prefix_attention_torch(q, k, v, *, prefix_len: int, window: int = 0,
                           logit_cap: float = 0.0):
    """Blockwise online softmax in plain PyTorch, block by block as the TPU
    kernel's ``_kernel``/``_accumulate`` compute it: 128-row query blocks
    over 128-key blocks, f32 accumulators, an unmasked fast path for blocks
    wholly visible to the query block, and ``acc / max(l, 1e-30)``."""
    prefix_attention_torch.calls += 1
    _check_shapes(q, k, v, prefix_len)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    R = H // KV
    bq = min(BLOCK, max(Sq, 8))
    bk = min(BLOCK, max(Skv, 8))
    nq, nk = -(-Sq // bq), -(-Skv // bk)
    dev = q.device
    # zero padding to whole blocks: padded keys sit past every valid query
    # position, so the causal mask removes them and the fast path never
    # fires on a block holding them
    qf = torch.zeros((B, KV, R, nq * bq, hd), device=dev)
    qf[..., :Sq, :] = q.float().reshape(B, KV, R, Sq, hd)
    kf = torch.zeros((B, KV, nk * bk, hd), device=dev)
    vf = torch.zeros((B, KV, nk * bk, hd), device=dev)
    kf[:, :, :Skv] = k.float()
    vf[:, :, :Skv] = v.float()
    scale = hd ** -0.5
    out = torch.empty((B, KV, R, nq * bq, hd), device=dev)
    rows = torch.arange(bq, device=dev)
    cols = torch.arange(bk, device=dev)
    for iq in range(nq):
        qb = qf[..., iq * bq:(iq + 1) * bq, :]
        q0 = prefix_len + iq * bq
        m = torch.full((B, KV, R, bq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, R, bq), device=dev)
        acc = torch.zeros((B, KV, R, bq, hd), device=dev)
        for ik in range(nk):
            kb = kf[:, :, ik * bk:(ik + 1) * bk]
            vb = vf[:, :, ik * bk:(ik + 1) * bk]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kb) * scale
            if logit_cap:
                s = logit_cap * torch.tanh(s / logit_cap)
            full = (ik + 1) * bk - 1 <= q0
            if window > 0:
                full &= ik * bk > q0 + bq - 1 - window
            if not full:
                q_pos = q0 + rows[:, None]
                k_pos = ik * bk + cols[None]
                mask = k_pos <= q_pos
                if window > 0:
                    mask &= k_pos > q_pos - window
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p, vb)
            m = m_new
        out[..., iq * bq:(iq + 1) * bq, :] = (
            acc / torch.clamp(l, min=1e-30)[..., None])
    return out[..., :Sq, :].reshape(B, H, Sq, hd).to(q.dtype)


prefix_attention_torch.calls = 0


def _check_cuda_args(q, k, v) -> None:
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("prefix_flash_attention: q, k and v must be on one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"prefix_flash_attention takes f32 or bf16 q/k/v of "
                         f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"prefix_flash_attention takes head_dim 64, 128 or "
                         f"256; got {hd}")
    if q.shape[1] // k.shape[1] > MAX_R:
        raise ValueError(f"at most {MAX_R} query heads per KV head")
    check_rows("prefix_flash_attention", q=q, k=k, v=v)


def prefix_flash_attention(q, k, v, *, prefix_len: int, window: int = 0,
                           logit_cap: float = 0.0):
    """Prefix-cached prefill attention: (B, H, Sq, hd).

    Replaces the TPU kernel ``repro/kernels/prefix_attention.py::
    prefix_flash_attention``.  Bound on the H100 by operations for long
    sequences, bytes for a short chunk after a long prefix.  bf16 runs on
    the tensor cores (mma.sync m16n8k16, f32 accumulation, P as hi + lo
    bf16 parts for the P @ V product) with 64-key K/V tiles (32-key at hd
    256) streamed through a cp.async ring; f32 on CUDA cores.  One CTA
    packs the R query heads of a KV head so each tile is read once for all
    of them, and skips tiles wholly past the causal frontier or before the
    window.  Tiles start at multiples of their size from key 0 and each is
    one online-softmax update, so a row's bits do not depend on the chunk
    it sits in (see csrc/attn_tile.cuh).  It also takes ``logit_cap``, which the TPU kernel
    lacks.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel on the current stream or raises.
    """
    if not q.is_cuda:
        return prefix_attention_torch(q, k, v, prefix_len=prefix_len,
                                      window=window, logit_cap=logit_cap)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, hd); got {tuple(q.shape)}")
    _check_shapes(q, k, v, prefix_len)
    _check_cuda_args(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    # (B, Sq, H, hd) buffer: the model's layout, returned as a view
    buf = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    out = buf.transpose(1, 2)
    if Sq == 0:
        return out
    lib = _build.load("prefix_attention")
    strides = [s for t in (q, k, v, out) for s in
               (t.stride(0), t.stride(2), t.stride(1))]
    code = lib.prefix_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Skv, hd, int(prefix_len), int(window), float(logit_cap),
        hd ** -0.5, int(q.dtype == torch.bfloat16), *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "prefix_attention", code)
    prefix_flash_attention.launches += 1
    return out


prefix_flash_attention.launches = 0
