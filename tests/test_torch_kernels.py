"""The port's plain paged-attention versions and dense oracles against the
JAX package's on identical inputs (made with numpy from a seed).

Covered: GQA R in {1, 2, 7}; counts == 0 entries pointing at a scratch
page; an all-empty decode row and padded prefill rows (exact zeros); doc
runs ending mid-block; window + softcap; a permuted block table.
Tolerances: f32 max abs <= 1e-5 (summation order only); bf16 compared in
f32, max abs <= 2e-2 (a few bf16 ulps of outputs below ~2).  The CUDA
kernels themselves run only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_prefill as PP
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PAGE = 16


def _runs(seg_lens, free):
    tables, counts, starts, pos = [], [], [], 0
    for n in seg_lens:
        for off in range(0, n, PAGE):
            tables.append(int(free.pop()))
            counts.append(min(PAGE, n - off))
            starts.append(pos + off)
        pos += n
    return tables, counts, starts, pos


def _pool(rng, n_pages, KV, hd, L=2):
    shape = (L, n_pages, PAGE, KV, hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def decode_inputs(seed, R, rows, n_slots=10, KV=2, hd=64):
    """rows[b]: segment lengths (docs then question); [] = empty row."""
    rng = np.random.default_rng(seed)
    n_pages = 2 + sum(-(-n // PAGE) for segs in rows for n in segs)
    free = list(rng.permutation(np.arange(1, n_pages)))   # 0 = scratch
    B = len(rows)
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    qpos = np.zeros((B,), np.int32)
    for b, segs in enumerate(rows):
        t, c, s, total = _runs(segs, free)
        tables[b, :len(t)], counts[b, :len(t)], starts[b, :len(t)] = t, c, s
        qpos[b] = max(total - 1, 0)
    k, v = _pool(rng, n_pages, KV, hd)
    q = rng.standard_normal((B, R * KV, hd)).astype(np.float32)
    return q, k, v, tables, counts, starts, qpos


def prefill_inputs(seed, R, rows, Sq, n_slots=12, KV=2, hd=64):
    """rows[b] = (cached prefix segment lengths, q_len); q_len 0 = padding."""
    rng = np.random.default_rng(seed)
    n_pages = 2 + sum(-(-n // PAGE) for pre, ql in rows
                      for n in list(pre) + [ql])
    free = list(rng.permutation(np.arange(1, n_pages)))
    B = len(rows)
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    q_start = np.zeros((B,), np.int32)
    q_len = np.zeros((B,), np.int32)
    for b, (pre, ql) in enumerate(rows):
        if ql:
            t, c, s, total = _runs(list(pre) + [ql], free)
            tables[b, :len(t)], counts[b, :len(t)] = t, c
            starts[b, :len(t)] = s
            q_start[b], q_len[b] = total - ql, ql
    k, v = _pool(rng, n_pages, KV, hd)
    q = rng.standard_normal((B, R * KV, Sq, hd)).astype(np.float32)
    return q, k, v, tables, counts, starts, q_start, q_len


def _to_jax(arrs, dtype):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrs]


def _to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            if a.dtype == np.float32 else torch.from_numpy(a) for a in arrs]


def _close(a_torch, b_jax, dtype):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= TOL[dtype], err
    return a


DECODE_ROWS = [[20, 13, 5], [], [16, 40, 3], [7]]     # row 1 all-empty
PREFILL_ROWS = [([20, 13], 24), ([], 17), ([], 0), ([33], 5)]  # row 2 pad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 2, 7])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (12, 20.0)])
def test_decode_plain_matches_jax(dtype, R, window, cap):
    ins = decode_inputs(R + window, R, DECODE_ROWS)
    jx = _to_jax(ins, dtype)
    tt = _to_torch(ins, dtype)
    want = jax_ops.paged_decode_attention(*jx, 1, window, logit_cap=cap,
                                          impl="jnp")
    got = ops.paged_decode_attention(*tt, 1, window, logit_cap=cap)
    out = _close(got, want, dtype)
    assert got.dtype == getattr(torch, dtype)
    assert (out[1] == 0).all()                    # all-empty row -> exact 0
    oracle = ref.reference_paged_decode(*tt, 1, window, cap)
    _close(oracle, jax_ref.reference_paged_decode(*jx, 1, window, cap),
           dtype)
    _close(got, jax_ref.reference_paged_decode(*jx, 1, window, cap), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 2, 7])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (12, 20.0)])
def test_prefill_plain_matches_jax(dtype, R, window, cap):
    Sq = 32
    ins = prefill_inputs(R + window + 1, R, PREFILL_ROWS, Sq)
    jx = _to_jax(ins, dtype)
    tt = _to_torch(ins, dtype)
    want = jax_ops.paged_prefill_attention(*jx, 1, window, logit_cap=cap,
                                           impl="jnp")
    got = ops.paged_prefill_attention(*tt, 1, window, logit_cap=cap)
    out = _close(got, want, dtype)
    q_len = ins[-1]
    for b in range(len(q_len)):
        assert (out[b, :, q_len[b]:] == 0).all()  # padding rows -> exact 0
    oracle = ref.reference_paged_prefill(*tt, 1, window, cap)
    _close(oracle, jax_ref.reference_paged_prefill(*jx, 1, window, cap),
           dtype)
    _close(got, jax_ref.reference_paged_prefill(*jx, 1, window, cap), dtype)


def test_block_table_permutation_is_invisible():
    """Moving the pages (and the table entries with them) changes nothing."""
    q, k, v, tables, counts, starts, qpos = decode_inputs(3, 7, DECODE_ROWS)
    perm = np.random.default_rng(4).permutation(k.shape[1])
    inv = np.argsort(perm)
    k2, v2 = k[:, perm], v[:, perm]
    t2 = inv[tables].astype(np.int32)
    a = PA.paged_decode_torch(*_to_torch([q, k, v, tables, counts, starts,
                                          qpos], "float32"), 1, 0)
    b = PA.paged_decode_torch(*_to_torch([q, k2, v2, t2, counts, starts,
                                          qpos], "float32"), 1, 0)
    assert torch.equal(a, b)


def test_decode_matches_pallas_interpret():
    """One smallest-shape case against the Pallas kernel body itself."""
    ins = decode_inputs(5, 2, [[20, 5], [], [9]], n_slots=4)
    want = jax_ops.paged_decode_attention(*_to_jax(ins, "float32"), 1, 0,
                                          impl="interpret")
    got = ops.paged_decode_attention(*_to_torch(ins, "float32"), 1, 0)
    _close(got, want, "float32")


def test_cuda_impl_on_cpu_tensors_raises():
    ins = _to_torch(decode_inputs(6, 2, [[9]]), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(*ins, 0, 0, impl="cuda")
    pins = _to_torch(prefill_inputs(6, 2, [([], 5)], 8), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_prefill_attention(*pins, 0, 0, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.paged_decode_attention(*ins, 0, 0, impl="pallas")


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    ins = _to_torch(decode_inputs(7, 2, [[9, 3]]), "float32")
    before = (PA.paged_decode_attention.launches, PA.paged_decode_torch.calls)
    out = PA.paged_decode_attention(*ins, 1, 0)
    assert PA.paged_decode_attention.launches == before[0]
    assert PA.paged_decode_torch.calls == before[1] + 1
    assert torch.equal(out, PA.paged_decode_torch(*ins, 1, 0))
    pins = _to_torch(prefill_inputs(7, 2, [([], 5)], 8), "float32")
    n = PP.paged_prefill_attention.launches
    PP.paged_prefill_attention(*pins, 1, 0)
    assert PP.paged_prefill_attention.launches == n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plain_takes_the_model_layout_view(dtype):
    """The (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer — what the model
    passes, and what the kernel reads in place — gives the results of a
    contiguous copy, bit for bit."""
    tt = _to_torch(prefill_inputs(21, 7, PREFILL_ROWS, 32), dtype)
    view = tt[0].transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous() and torch.equal(view, tt[0])
    a = ops.paged_prefill_attention(view, *tt[1:], 1, 12, logit_cap=20.0)
    b = ops.paged_prefill_attention(view.contiguous(), *tt[1:], 1, 12,
                                    logit_cap=20.0)
    assert torch.equal(a, b)


def test_row_check_takes_views_and_refuses_split_rows():
    q = torch.zeros((2, 6, 3, 64), dtype=torch.bfloat16)
    PA.check_rows("t", q=q, view=q.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous last dimension"):
        PA.check_rows("t", q=q.transpose(2, 3))
    with pytest.raises(ValueError, match="multiples of 8"):
        PA.check_rows("t", q=q[..., 1:61])


@pytest.mark.parametrize("B,H,KV,hd,page,npages,nslots", [
    (2, 4, 2, 32, 8, 16, 4),
    (1, 8, 8, 64, 16, 8, 3),
    (3, 4, 4, 128, 8, 32, 6),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_sweep_matches_jax(B, H, KV, hd, page, npages,
                                           nslots, dtype):
    """Twin of tests/test_kernels.py::test_paged_attention_sweep: the
    single-layer ``paged_attention`` against the Pallas kernel in interpret
    mode, and the port's dense oracle against the reference's, on the same
    inputs; the port's wrapper against its own oracle at the reference
    test's tolerance (1e-4 in f32, 2e-2 in bf16)."""
    rng = np.random.default_rng(B * 100 + hd)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (npages, page, KV, hd),
                      (npages, page, KV, hd))]
    arrs += [rng.integers(0, npages, (B, nslots)).astype(np.int32),
             rng.integers(1, page * nslots + 1, (B,)).astype(np.int32)]
    jin, tin = _to_jax(arrs, dtype), _to_torch(arrs, dtype)
    got = ops.paged_attention(*tin)
    _close(got, jax_ops.paged_attention(*jin, interpret=True), dtype)
    oracle = ref.reference_paged_attention(*tin)
    _close(oracle, jax_ref.reference_paged_attention(*jin), dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert float((got.float() - oracle.float()).abs().max()) <= tol


def test_paged_attention_respects_block_table_permutation():
    """Twin of the reference's test of the same name: one logical sequence
    under two physical page placements gives identical outputs."""
    rng = np.random.default_rng(11)
    B, H, KV, hd, page, nslots, npages = 1, 4, 2, 32, 8, 3, 12
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    kv = torch.from_numpy(
        rng.standard_normal((nslots * page, KV, hd)).astype(np.float32))
    lengths = torch.tensor([20], dtype=torch.int32)

    def place(order):
        kp = torch.zeros((npages, page, KV, hd))
        vp = torch.zeros((npages, page, KV, hd))
        for i, pg in enumerate(order):
            kp[pg] = kv[i * page:(i + 1) * page]
            vp[pg] = kv[i * page:(i + 1) * page] * 0.5
        return kp, vp, torch.tensor([order], dtype=torch.int32)

    o1 = ops.paged_attention(q, *place([0, 1, 2]), lengths)
    o2 = ops.paged_attention(q, *place([7, 3, 11]), lengths)
    assert float((o1 - o2).abs().max()) <= 1e-6
    assert torch.equal(ops.paged_attention(q, *place([0, 1, 2]), lengths,
                                           impl="torch"), o1)
