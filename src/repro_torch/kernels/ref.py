"""Dense torch oracles for the attention kernels (counterparts of
``repro.kernels.ref.reference_prefix_attention``, ``reference_paged_prefill``,
``reference_paged_decode`` and ``reference_paged_attention``).

They run a plain masked softmax over the whole context — for the paged
kernels after gathering every table entry's page into a dense
(B, n_slots * page, KV, hd) context — simple enough to trust, too big to
serve with.  Tests hold the plain versions and the CUDA kernels against
them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_prefix_attention(q, k, v, *, prefix_len: int, window: int = 0,
                               logit_cap: float = 0.0):
    """q: (B, H, Sq, hd); k/v: (B, KV, Skv, hd) with Skv = prefix_len + Sq.
    Query row i sits at absolute position prefix_len + i."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    R = H // KV
    kf = k.repeat_interleave(R, dim=1).float()
    vf = v.repeat_interleave(R, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * hd ** -0.5
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = prefix_len + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def _dense_kv(k_pages, v_pages, tables, layer: int, R: int):
    B, nb = tables.shape
    page, KV, hd = k_pages.shape[2:]
    idx = tables.long()
    k = k_pages[layer][idx].reshape(B, nb * page, KV, hd)
    v = v_pages[layer][idx].reshape(B, nb * page, KV, hd)
    kf = k.repeat_interleave(R, dim=2).float()
    vf = v.repeat_interleave(R, dim=2).float()
    return kf, vf


def _slot_live(counts, starts, page: int):
    """(B, nb * page) live flags and absolute key positions of the runs."""
    B, nb = counts.shape
    slot = torch.arange(page, device=counts.device)
    live = (slot[None, None] < counts[..., None]).reshape(B, nb * page)
    kpos = (starts[..., None] + slot[None, None]).reshape(B, nb * page)
    return live, kpos


def reference_paged_prefill(q, k_pages, v_pages, tables, counts, starts,
                            q_start, q_len, layer: int, window: int = 0,
                            logit_cap: float = 0.0):
    """Dense oracle for the layer-major paged prefill kernel.

    q: (B, H, Sq, hd); k/v_pages: (L, n_pages, page, KV, hd); tables/counts/
    starts: (B, n_slots) run descriptors (see paged_attention.py); q_start:
    (B,) absolute position of query row 0; q_len: (B,) valid query rows —
    invalid (ragged-padding) rows return exact zeros.
    """
    B, H, Sq, hd = q.shape
    page, KV = k_pages.shape[2], k_pages.shape[3]
    kf, vf = _dense_kv(k_pages, v_pages, tables, layer, H // KV)
    s = torch.einsum("bhqd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    live, kpos = _slot_live(counts, starts, page)
    rows = torch.arange(Sq, device=q.device)
    qpos = q_start[:, None] + rows[None]                     # (B, Sq)
    mask = live[:, None] & (kpos[:, None] <= qpos[..., None])
    mask &= (rows[None] < q_len[:, None])[..., None]
    if window:
        mask &= kpos[:, None] > qpos[..., None] - window
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[:, None], p, 0.0)   # all-masked row -> 0, not NaN
    return torch.einsum("bhqk,bkhd->bhqd", p, vf).to(q.dtype)


def reference_paged_decode(q, k_pages, v_pages, tables, counts, starts, qpos,
                           layer: int, window: int = 0,
                           logit_cap: float = 0.0):
    """Dense oracle for the layer-major paged decode kernel.

    q: (B, H, hd); k/v_pages: (L, n_pages, page, KV, hd); tables/counts/
    starts: (B, n_slots) run descriptors; qpos: (B,) absolute query
    position; layer selects the page plane.
    """
    B, H, hd = q.shape
    page, KV = k_pages.shape[2], k_pages.shape[3]
    kf, vf = _dense_kv(k_pages, v_pages, tables, layer, H // KV)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) * hd ** -0.5
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    live, kpos = _slot_live(counts, starts, page)
    if window:
        live &= kpos > qpos[:, None] - window
    s = torch.where(live[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(live[:, None], p, 0.0)   # all-masked row -> 0, not NaN
    return torch.einsum("bhk,bkhd->bhd", p, vf).to(q.dtype)


def reference_paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """Dense oracle for the single-layer ``paged_attention``.  q: (B, H,
    hd); k/v_pages: (n_pages, page, KV, hd); block_tables: (B, n_slots)
    int32; lengths: (B,) valid tokens.  As in the reference, a row of
    length 0 averages its values instead of giving zeros."""
    B, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, nb * page, KV, hd)
    v = v_pages[idx].reshape(B, nb * page, KV, hd)
    kf = k.repeat_interleave(H // KV, dim=2).float()
    vf = v.repeat_interleave(H // KV, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) * hd ** -0.5
    mask = torch.arange(nb * page, device=q.device)[None] < lengths[:, None]
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vf).to(q.dtype)
