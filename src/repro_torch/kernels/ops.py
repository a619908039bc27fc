"""Dispatch for the attention kernels (counterpart of
``repro.kernels.ops``).

  impl=None    -> the CUDA kernel for a CUDA tensor, the plain PyTorch
                  version for a CPU tensor
  impl="cuda"  -> force the kernel (raises for a CPU tensor)
  impl="torch" -> force the plain version (on either device)

Tensor parallelism is not ported yet (ROADMAP.md Queue A item 6), so there
is no sharded path.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pg
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import prefix_attention as _pa


def _resolve(impl, q) -> str:
    if impl is None:
        return "cuda" if q.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "cuda" and not q.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got tensors on "
                         f"{q.device}")
    return impl


def prefix_attention(q, k, v, *, prefix_len: int, window: int = 0,
                     logit_cap: float = 0.0, impl: str | None = None):
    """Prefill over dense [cached prefix ‖ new] KV (the dense prefill's
    attention; see prefix_attention.py).  Layouts: q (B, H, Sq, hd); k/v
    (B, KV, prefix_len + Sq, hd)."""
    if _resolve(impl, q) == "torch":
        return _pa.prefix_attention_torch(q, k, v, prefix_len=prefix_len,
                                          window=window, logit_cap=logit_cap)
    return _pa.prefix_flash_attention(q, k, v, prefix_len=prefix_len,
                                      window=window, logit_cap=logit_cap)


def paged_decode_attention(q, k_pages, v_pages, tables, counts, starts, qpos,
                           layer: int, window: int, *,
                           logit_cap: float = 0.0, impl: str | None = None):
    """Decode attention straight from the pool's layer-major page arrays
    (see paged_attention.py for the run-table contract)."""
    if _resolve(impl, q) == "torch":
        return _pg.paged_decode_torch(q, k_pages, v_pages, tables, counts,
                                      starts, qpos, layer, window,
                                      logit_cap=logit_cap)
    return _pg.paged_decode_attention(q, k_pages, v_pages, tables, counts,
                                      starts, qpos, layer, window,
                                      logit_cap=logit_cap)


def paged_prefill_attention(q, k_pages, v_pages, tables, counts, starts,
                            q_start, q_len, layer: int, window: int, *,
                            logit_cap: float = 0.0, impl: str | None = None):
    """Ragged prefill attention straight from the pool's layer-major page
    arrays (see paged_prefill.py for the query-row contract)."""
    if _resolve(impl, q) == "torch":
        return _pp.paged_prefill_torch(q, k_pages, v_pages, tables, counts,
                                       starts, q_start, q_len, layer, window,
                                       logit_cap=logit_cap)
    return _pp.paged_prefill_attention(q, k_pages, v_pages, tables, counts,
                                       starts, q_start, q_len, layer, window,
                                       logit_cap=logit_cap)
