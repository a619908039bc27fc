"""Paged ragged prefill attention straight from the serving pool
(counterpart of ``repro.kernels.paged_prefill``).

Same run-table contract as paged decode (``tables/counts/starts``, see
``paged_attention.py``) plus a block of query rows per request: query row
``i`` of request ``b`` sits at absolute position ``q_start[b] + i`` and is
valid iff ``i < q_len[b]``.  Attention is causal on absolute positions;
invalid (ragged-padding) rows give exact zeros, which keeps a padded
batched call row-independent — each request's outputs are identical
whatever else shares the batch.

Layouts: q ``(B, H, Sq, hd)`` with any strides and a contiguous last
dimension — the model passes a view of its ``(B, Sq, H, hd)`` activations.
``paged_prefill_attention`` wraps the hand-written CUDA kernel
(``csrc/paged_prefill.cu``), reads q in place and returns a
``(B, H, Sq, hd)`` view of a ``(B, Sq, H, hd)`` buffer, so no copy is made
either way; ``paged_prefill_torch`` is its plain PyTorch version, which the
wrapper runs for tensors on the CPU and which takes the same views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (check_pool_args,
                                                 used_entries)

NEG_INF = -1e30


def paged_prefill_torch(q, k_pages, v_pages, tables, counts, starts, q_start,
                        q_len, layer: int, window: int, *,
                        logit_cap: float = 0.0):
    """Per-page gather + online softmax in plain PyTorch (twin of
    ``repro.kernels.paged_prefill.paged_prefill_jnp``).

    q: (B, H, Sq, hd), any strides (the views the kernel takes);
    k/v_pages: (L, n_pages, page, KV, hd); tables/counts/
    starts: (B, n_slots) int32; q_start/q_len: (B,) int32.  Peak live memory
    per step is one (B, page, KV, hd) tile plus the (B, H, Sq, page) scores.
    """
    paged_prefill_torch.calls += 1
    B, H, Sq, hd = q.shape
    page, KV = k_pages.shape[2], k_pages.shape[3]
    R = H // KV
    dev = q.device
    # contiguous operands of batched products over (row, KV head) blocks:
    # a block's bits do not depend on how many heads share the call
    qf = (q.float() * hd ** -0.5).reshape(B, KV, R * Sq, hd).contiguous()
    slot = torch.arange(page, device=dev, dtype=torch.int32)
    qrow = torch.arange(Sq, device=dev, dtype=torch.int32)
    qpos = q_start[:, None] + qrow[None]                   # (B, Sq)
    qvalid = qrow[None] < q_len[:, None]                   # (B, Sq)
    kl, vl = k_pages[layer], v_pages[layer]
    m = torch.full((B, KV, R, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, KV, R, Sq), device=dev)
    acc = torch.zeros((B, KV, R, Sq, hd), device=dev)
    for j in range(used_entries(counts)):
        pid = tables[:, j].long()
        k = kl[pid].float()                                # (B, page, KV, hd)
        v = vl[pid].float()
        s = torch.matmul(qf, k.permute(0, 2, 3, 1).contiguous()) \
            .reshape(B, KV, R, Sq, page)
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        kpos = starts[:, j, None] + slot[None]             # (B, page)
        live = slot[None] < counts[:, j, None]             # (B, page)
        mask = live[:, None] & (kpos[:, None] <= qpos[..., None])
        mask &= qvalid[..., None]                          # (B, Sq, page)
        if window > 0:
            mask &= kpos[:, None] > qpos[..., None] - window
        mb = mask[:, None, None]                           # (B,1,1,Sq,page)
        s = torch.where(mb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mb, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.reshape(B, KV, R * Sq, page),
                          v.permute(0, 2, 1, 3).contiguous())
        acc = acc * alpha[..., None] + pv.reshape(B, KV, R, Sq, hd)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).to(q.dtype)


paged_prefill_torch.calls = 0


def paged_prefill_attention(q, k_pages, v_pages, tables, counts, starts,
                            q_start, q_len, layer: int, window: int, *,
                            logit_cap: float = 0.0):
    """Ragged prefill attention through the run tables: (B, H, Sq, hd).

    Replaces the TPU kernel ``repro/kernels/paged_prefill.py::
    paged_prefill_attention``.  Bound on the H100 by operations for long
    chunks, bytes for short ones over long caches.  bf16 runs on the tensor
    cores (mma.sync m16n8k16, f32 accumulation, P as hi + lo bf16 parts
    for the P @ V product) with K/V pages streamed through a cp.async
    ring; f32 on CUDA cores.  One CTA packs the R query heads of a KV head
    so each page is read once for all of them, and skips empty entries and
    entries past the causal frontier or outside the window.  Every page is
    one online-softmax update, so a row's bits do not depend on the chunk
    it sits in (see csrc/attn_tile.cuh).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream or
    raises.
    """
    if not q.is_cuda:
        return paged_prefill_torch(q, k_pages, v_pages, tables, counts,
                                   starts, q_start, q_len, layer, window,
                                   logit_cap=logit_cap)
    check_pool_args("paged_prefill_attention", q, k_pages, v_pages,
                    (tables, counts, starts, q_start, q_len), q_rank=4,
                    strided_q=True)
    B, H, Sq, hd = q.shape
    L, n_pages, page, KV, _ = k_pages.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    if tables.shape != counts.shape or tables.shape != starts.shape \
            or tables.shape[0] != B or q_start.shape != (B,) \
            or q_len.shape != (B,):
        raise ValueError("run tables must be (B, n_slots), q_start and "
                         "q_len (B,)")
    # (B, Sq, H, hd) buffer: the model's layout, returned as a view
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0:
        return out
    lib = _build.load("paged_prefill")
    strides = [s for t in (q, out) for s in
               (t.stride(0), t.stride(2), t.stride(1))]
    code = lib.paged_prefill_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), counts.data_ptr(), starts.data_ptr(),
        q_start.data_ptr(), q_len.data_ptr(), out.data_ptr(), B, H, KV, Sq,
        hd, n_pages, page, tables.shape[1], int(layer), int(window),
        float(logit_cap), hd ** -0.5, int(q.dtype == torch.bfloat16),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "paged_prefill", code)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
