"""Paged decode attention straight from the serving pool (counterpart of
``repro.kernels.paged_attention``).

The pool is the ``PagedKVStore``'s layer-major ``k_pages/v_pages:
(L, n_pages, page, KV, hd)``.  A request's sequence is a list of *runs*,
one per table entry ``j``: page ``tables[b, j]`` holds the ``counts[b, j]``
consecutive tokens starting at absolute position ``starts[b, j]``, always
beginning at slot 0.  ``counts[b, j] == 0`` marks an unused entry (point it
at a valid scratch page).  GQA maps head ``h`` to KV head ``h // (H // KV)``;
the logit softcap applies before the mask; the sliding window is on absolute
positions (``pos > qpos - window``).  A row whose runs are all empty gives
exact zeros.

``paged_decode_attention`` is the wrapper of the hand-written CUDA kernel
(``csrc/paged_decode.cu``: CTAs over fixed ranges of table entries, whose
partials the last of them to finish merges in a fixed order);
``paged_decode_torch`` is its plain PyTorch version — a per-page gather +
online softmax with the JAX twin's masking — which the wrapper runs for
tensors on the CPU.  ``paged_attention`` is the single-layer convenience
form over that wrapper (contiguous runs from a block table and lengths).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_R = 16          # query heads per KV head the CUDA kernels take
MAX_PAGE = 32       # page (block) size the CUDA kernels take
HEAD_DIMS = (64, 128, 256)   # head dims the CUDA kernels take
# keys a split of the CUDA decode kernel covers (csrc/paged_decode.cu
# SPLIT_KEYS), and for rows above 256 bytes (f32 at hd 128, both dtypes at
# hd 256: SPLIT_KEYS_WIDE)
SPLIT_KEYS = 128
SPLIT_KEYS_WIDE = 64


def used_entries(counts) -> int:
    """Table entries up to the last one any row uses: an entry that no row
    uses masks every key, so leaving the trailing ones out of the plain
    versions' loops changes no bit of their results."""
    used = (counts > 0).any(dim=0).nonzero()
    return int(used.max()) + 1 if used.numel() else 0


def paged_decode_torch(q, k_pages, v_pages, tables, counts, starts, qpos,
                       layer: int, window: int, *, logit_cap: float = 0.0):
    """Per-page gather + online softmax in plain PyTorch (twin of
    ``repro.kernels.paged_attention.paged_decode_jnp``).

    q: (B, H, hd); k/v_pages: (L, n_pages, page, KV, hd); tables/counts/
    starts: (B, n_slots) int32; qpos: (B,) int32.  Peak live memory per
    step is one (B, page, KV, hd) tile.
    """
    paged_decode_torch.calls += 1
    B, H, hd = q.shape
    page, KV = k_pages.shape[2], k_pages.shape[3]
    R = H // KV
    qf = (q.float() * hd ** -0.5).reshape(B, KV, R, hd)
    slot = torch.arange(page, device=q.device, dtype=torch.int32)
    kl, vl = k_pages[layer], v_pages[layer]
    m = torch.full((B, KV, R), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, R), device=q.device)
    acc = torch.zeros((B, KV, R, hd), device=q.device)
    for j in range(used_entries(counts)):
        pid = tables[:, j].long()
        k = kl[pid].float()                              # (B, page, KV, hd)
        v = vl[pid].float()
        # contiguous operands of one batched product: each (row, KV head)
        # block's bits do not depend on how many heads share the call
        s = torch.matmul(qf, k.permute(0, 2, 3, 1).contiguous())
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        live = slot[None] < counts[:, j, None]           # (B, page)
        if window > 0:
            pos = starts[:, j, None] + slot[None]
            live &= pos > qpos[:, None] - window
        lb = live[:, None, None, :]
        s = torch.where(lb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(lb, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p, v.permute(0, 2, 1, 3).contiguous())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


paged_decode_torch.calls = 0


def check_rows(name, **tensors) -> None:
    """Raise unless each tensor's rows can be read in place by 16-byte
    loads: a contiguous last dimension, a 16-byte aligned base, and every
    other stride a multiple of 16 bytes."""
    for tname, t in tensors.items():
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(
                f"{name}: {tname} needs a contiguous last dimension, a "
                f"16-byte aligned base and strides that are multiples of "
                f"{vec} elements; got strides {t.stride()}")


def check_pool_args(name, q, k_pages, v_pages, ints, *, q_rank: int,
                    strided_q: bool = False):
    """Validate what the CUDA kernels take; raise on anything else.  With
    ``strided_q`` the kernel reads q through its strides (``check_rows``)
    instead of requiring it contiguous."""
    if q.dim() != q_rank or k_pages.dim() != 5:
        raise ValueError(f"{name}: q must be {q_rank}-D and the pool 5-D")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: k_pages and v_pages differ in shape")
    dev = q.device
    for t in (k_pages, v_pages, *ints):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype must be bfloat16 or float32, "
                        f"got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q and the pool must share one dtype")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32")
    for t in (k_pages, v_pages, *ints) + (() if strided_q else (q,)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    if strided_q:
        check_rows(name, q=q)
    H, hd = q.shape[1], q.shape[-1]
    page, KV = k_pages.shape[2], k_pages.shape[3]
    if hd not in HEAD_DIMS or k_pages.shape[4] != hd:
        raise ValueError(f"{name}: head dim must be 64, 128 or 256, got "
                         f"{hd}")
    if H % KV or H // KV > MAX_R:
        raise ValueError(f"{name}: need H % KV == 0 and H / KV <= {MAX_R}, "
                         f"got H={H} KV={KV}")
    if not 0 < page <= MAX_PAGE:
        raise ValueError(f"{name}: page size must be in 1..{MAX_PAGE}")


def decode_splits(n_slots: int, page: int, hd: int, dtype) -> int:
    """Splits a row of the CUDA decode kernel: a split covers max(1, keys
    // page) table entries, keys fixed by the row width alone, never by the
    batch or a row's length, so a row's bits depend only on its own run
    table.  A table of no entries still gets one (empty) split."""
    wide = dtype.itemsize * hd > 256
    per = max(1, (SPLIT_KEYS_WIDE if wide else SPLIT_KEYS) // page)
    return max(1, -(-n_slots // per))


_COUNTERS = {}


def _counters(device, n: int):
    """The decode kernel's per-(row, KV head) counters of finished splits,
    one zeroed int32 buffer per device: the CTA that merges a row resets
    its counter, so the buffer is zero again after every launch."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def paged_decode_attention(q, k_pages, v_pages, tables, counts, starts, qpos,
                           layer: int, window: int, *,
                           logit_cap: float = 0.0):
    """Decode attention through the run tables: (B, H, hd) in q's dtype.

    Replaces the TPU kernel ``repro/kernels/paged_attention.py::
    paged_decode_attention``.  Bound on the H100 by bytes (the live K/V
    pages); each split CTA reads its pages once per KV head for all of its
    query heads and skips empty table entries, and the last CTA of a row
    merges the splits' f32 partials in a fixed order (see
    csrc/paged_decode.cu).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises.
    """
    if not q.is_cuda:
        return paged_decode_torch(q, k_pages, v_pages, tables, counts, starts,
                                  qpos, layer, window, logit_cap=logit_cap)
    check_pool_args("paged_decode_attention", q, k_pages, v_pages,
                    (tables, counts, starts, qpos), q_rank=3)
    B, H, hd = q.shape
    L, n_pages, page, KV, _ = k_pages.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    if tables.shape != counts.shape or tables.shape != starts.shape \
            or tables.shape[0] != B or qpos.shape != (B,):
        raise ValueError("run tables must be (B, n_slots) and qpos (B,)")
    if L * n_pages * page >= 2 ** 31:
        raise ValueError("the kernel indexes pool rows with 32-bit ints: "
                         f"{L * n_pages * page} rows")
    check_rows("paged_decode_attention", q=q, k_pages=k_pages,
               v_pages=v_pages)
    n_slots = tables.shape[1]
    n_split = decode_splits(n_slots, page, hd, q.dtype)
    out = torch.empty_like(q)
    # the splits' partials in f32: acc (B, H, n_split, hd), then m and l
    # (B, H, n_split)
    part = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("paged_decode")
    code = lib.paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), counts.data_ptr(), starts.data_ptr(),
        qpos.data_ptr(), out.data_ptr(), part.data_ptr(),
        _counters(q.device, B * KV).data_ptr(), B, H, KV, hd, n_pages,
        page, n_slots, n_split, int(layer), int(window), float(logit_cap),
        hd ** -0.5, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "paged_decode", code)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def single_layer_runs(block_tables, lengths, page: int):
    """The run tables (tables, counts, starts, qpos) of single-layer
    contiguous semantics: entry ``j`` of row ``b`` holds positions
    ``[j * page, ...)`` up to ``lengths[b]``, the query at the last."""
    n_slots = block_tables.shape[1]
    off = torch.arange(n_slots, dtype=torch.int32,
                       device=block_tables.device)[None] * page
    lengths = lengths.to(torch.int32)
    counts = torch.clamp(lengths[:, None] - off, 0, page).to(torch.int32)
    starts = off.expand(block_tables.shape).contiguous()
    qpos = torch.clamp(lengths - 1, min=0)
    return (block_tables.to(torch.int32).contiguous(), counts.contiguous(),
            starts, qpos.contiguous())


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """Single-layer decode attention over a block table (counterpart of
    ``repro.kernels.paged_attention.paged_attention``): contiguous
    semantics (``single_layer_runs``) through ``paged_decode_attention``
    at layer 0, no window.

    q: (B, H, hd); k/v_pages: (n_pages, page, KV, hd); block_tables:
    (B, n_slots) int32 page ids; lengths: (B,) valid tokens.  Takes the
    kernel for CUDA tensors and the plain version for CPU ones."""
    runs = single_layer_runs(block_tables, lengths, k_pages.shape[1])
    return paged_decode_attention(q, k_pages[None], v_pages[None], *runs,
                                  0, 0)
