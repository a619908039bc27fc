"""Dispatch for the attention kernels (counterpart of
``repro.kernels.ops``).

  impl=None    -> the CUDA kernel for a CUDA tensor, the plain PyTorch
                  version for a CPU tensor
  impl="cuda"  -> force the kernel (raises for a CPU tensor)
  impl="torch" -> force the plain version (on either device)

Under the compile analysis (``launch/op_analysis.py``) a kernel call is
counted at its own formula: a fake tensor (``FakeTensorMode``) gets the
kernel's output shape and dtype and nothing runs; a real one runs as
above with the tally paused.  The plain version's block loop is never
counted in the kernel's place.

``mesh``: the serving mesh (``launch/mesh.py``; one shard at tp 1).  With
a mesh the paged ops take the pool's list of planes, one per shard, and
dispatch the same kernel (or plain version) PER SHARD: shard i
gets q's heads [i H/tp, (i+1) H/tp) on its device and its plane of KV/tp
heads, with the run tables copied once to each distinct device (they do
not depend on heads); the outputs are concatenated along heads on q's
device (one shard's output as it is).  No collectives: attention is
independent across heads.  Shards that share a device launch on its
current stream, in shard order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _pg
from repro_torch.launch import op_analysis
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


def prefix_pairs(prefix_len: int, sq: int, window: int) -> int:
    """The (query, key) pairs the prefix kernel's masks leave visible over
    ``sq`` query rows after ``prefix_len`` cached keys: row i sees
    ``min(prefix_len + i + 1, window)`` keys (all of them without a
    window)."""
    a, b = prefix_len + 1, prefix_len + sq      # keys seen by the first, last
    if sq <= 0:
        return 0
    if window <= 0 or b <= window:
        return (a + b) * (b - a + 1) // 2
    lo = (a + window) * (window - a + 1) // 2 if a <= window else 0
    return lo + (b - max(a, window + 1) + 1) * window


def _prefix_counted(q, k, v, prefix_len, window, logit_cap, impl):
    """``prefix_attention`` under the compile analysis: one kernel call at
    the kernel's formula (QK and PV over the visible pairs; q, k, v read
    and the output written once); a fake call's output is the kernel's
    (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer."""
    B, H, Sq, hd = q.shape
    op_analysis.note(
        q.device,
        4 * B * H * hd * prefix_pairs(int(prefix_len), Sq, int(window)),
        (2 * q.numel() + 2 * k.numel()) * q.element_size(),
        kernel="prefix_flash_attention")
    if op_analysis.is_fake(q):
        _pa._check_shapes(q, k, v, int(prefix_len))
        return torch.empty((B, Sq, H, hd), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    with op_analysis.paused() as run:
        out = prefix_attention(q, k, v, prefix_len=prefix_len, window=window,
                               logit_cap=logit_cap, impl=impl)
    return run.keep(out)


def prefix_attention(q, k, v, *, prefix_len: int, window: int = 0,
                     logit_cap: float = 0.0, impl: str | None = None):
    """Prefill over dense [cached prefix ‖ new] KV (the dense prefill's
    attention; see prefix_attention.py).  Layouts: q (B, H, Sq, hd); k/v
    (B, KV, prefix_len + Sq, hd)."""
    tally = op_analysis.active()
    if op_analysis.is_fake(q) or (tally is not None and not tally.quiet):
        return _prefix_counted(q, k, v, prefix_len, window, logit_cap, impl)
    if _resolve(impl, q) == "torch":
        return _pa.prefix_attention_torch(q, k, v, prefix_len=prefix_len,
                                          window=window, logit_cap=logit_cap)
    return _pa.prefix_flash_attention(q, k, v, prefix_len=prefix_len,
                                      window=window, logit_cap=logit_cap)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    impl: str | None = None):
    """Single-layer decode attention over paged KV (contiguous runs from a
    block table and lengths; see paged_attention.py).  q: (B, H, hd); k/v
    pages: (n_pages, page, KV, hd)."""
    fn = (_pg.paged_decode_torch if _resolve(impl, q) == "torch"
          else _pg.paged_decode_attention)
    runs = _pg.single_layer_runs(block_tables, lengths, k_pages.shape[1])
    return fn(q, k_pages[None], v_pages[None], *runs, 0, 0)


def _per_shard(fn, q, k_planes, v_planes, ints, mesh, axis, **kw):
    """``fn(q_i, k_planes[i], v_planes[i], *ints, **kw)`` for each shard
    i, q_i the shard's heads (dim 1) on its device; outputs concatenated
    along heads on q's device."""
    tp = mesh.shape[axis]
    if len(k_planes) != tp or len(v_planes) != tp:
        raise ValueError(f"a mesh of {tp} shards needs {tp} pool planes")
    hs = q.shape[1] // tp
    placed = {d: tuple(t.to(d) for t in ints)
              for d in dict.fromkeys(mesh.devices)}
    outs = []
    for i, dev in enumerate(mesh.devices):
        qi = q[:, i * hs:(i + 1) * hs].to(dev)
        outs.append(fn(qi, k_planes[i], v_planes[i], *placed[dev], **kw))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def paged_decode_attention(q, k_pages, v_pages, tables, counts, starts, qpos,
                           layer: int, window: int, *,
                           logit_cap: float = 0.0, impl: str | None = None,
                           mesh=None, axis: str = "model"):
    """Decode attention straight from the pool's layer-major page arrays
    (see paged_attention.py for the run-table contract); with a ``mesh``,
    per shard over the pool's planes (``_paged_decode_sharded``)."""
    if mesh is not None:
        return _paged_decode_sharded(q, k_pages, v_pages, tables, counts,
                                     starts, qpos, layer, window,
                                     logit_cap=logit_cap, impl=impl,
                                     mesh=mesh, axis=axis)
    if _resolve(impl, q) == "torch":
        return _pg.paged_decode_torch(q, k_pages, v_pages, tables, counts,
                                      starts, qpos, layer, window,
                                      logit_cap=logit_cap)
    return _pg.paged_decode_attention(q, k_pages, v_pages, tables, counts,
                                      starts, qpos, layer, window,
                                      logit_cap=logit_cap)


def _paged_decode_sharded(q, k_planes, v_planes, tables, counts, starts,
                          qpos, layer, window, *, logit_cap, impl, mesh,
                          axis):
    """Per-shard dispatch of decode: each shard's H/tp query heads (made
    contiguous, as the kernel reads them) over its KV/tp-head plane, the
    split count and merge order unchanged (they depend on the run tables
    and the row width only)."""
    def one(qi, kp, vp, tb, cn, st, qp):
        return paged_decode_attention(qi.contiguous(), kp, vp, tb, cn, st,
                                      qp, layer, window,
                                      logit_cap=logit_cap, impl=impl)
    return _per_shard(one, q, k_planes, v_planes,
                      (tables, counts, starts, qpos), mesh, axis)


def paged_prefill_attention(q, k_pages, v_pages, tables, counts, starts,
                            q_start, q_len, layer: int, window: int, *,
                            logit_cap: float = 0.0, impl: str | None = None,
                            mesh=None, axis: str = "model"):
    """Ragged prefill attention straight from the pool's layer-major page
    arrays (see paged_prefill.py for the query-row contract); with a
    ``mesh``, per shard over the pool's planes (``_paged_prefill_sharded``).
    """
    if mesh is not None:
        return _paged_prefill_sharded(q, k_pages, v_pages, tables, counts,
                                      starts, q_start, q_len, layer, window,
                                      logit_cap=logit_cap, impl=impl,
                                      mesh=mesh, axis=axis)
    if _resolve(impl, q) == "torch":
        return _pp.paged_prefill_torch(q, k_pages, v_pages, tables, counts,
                                       starts, q_start, q_len, layer, window,
                                       logit_cap=logit_cap)
    return _pp.paged_prefill_attention(q, k_pages, v_pages, tables, counts,
                                       starts, q_start, q_len, layer, window,
                                       logit_cap=logit_cap)


def _paged_prefill_sharded(q, k_planes, v_planes, tables, counts, starts,
                           q_start, q_len, layer, window, *, logit_cap, impl,
                           mesh, axis):
    """Per-shard dispatch of prefill: the decode scheme with the Sq query
    axis riding along unsharded; each shard's q heads are read in place
    through their strides where they already sit on its device."""
    def one(qi, kp, vp, tb, cn, st, qs, ql):
        return paged_prefill_attention(qi, kp, vp, tb, cn, st, qs, ql,
                                       layer, window, logit_cap=logit_cap,
                                       impl=impl)
    return _per_shard(one, q, k_planes, v_planes,
                      (tables, counts, starts, q_start, q_len), mesh, axis)
