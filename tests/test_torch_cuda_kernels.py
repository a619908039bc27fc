"""The CUDA attention kernels against their plain versions on random
shapes, on the card (marked ``cuda``; each test skips without one):

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Cases come from numpy seeds: GQA widths R in {1, 2, 7, 16}, one or two KV
heads, head dims 64 and 128, pages of 1 to 32 keys, ragged rows after
cached prefixes, empty and padding rows, windows and softcaps, f32 (the
prefill kernels' CUDA-core bodies) and bf16 (their tensor-core bodies);
decode rows up to ~1,600 keys, so that a row spans 8 or more of the decode
kernel's splits.  Tolerances are chip_smoke.py's: f32 1e-4 (summation order
only), bf16 2e-2 (one bf16 ulp of outputs below 4: the tensor cores take P
rounded to bf16), and in bf16 each output row within 1e-2 of its size
against the plain version run in f32 on the same inputs.  Padding and
all-empty rows must be exactly 0.  Every prefill row must keep its bits
when recomputed as a later chunk of the same prefill, and every decode row
alone, beside other neighbours' pages, and in a narrower or wider table.
Prefill also runs over tables laid out as ``--reuse chunk`` lays them out:
computed pages between shared runs, and a chunk whose q_start lies past
shared runs and before others.  Fixed cases hold all three kernels at the
paper models' head shapes (hd 128, 32 query heads over Mistral-7B's 8 KV
heads and LLaMA2-7B's 32), in both dtypes, and under Mistral's 4096-token
window over rows of more than 4096 keys, with the same bit checks; and at
Gemma3-12B's (hd 256, 16 query heads over 8 KV heads), under its
1024-token window and without it, on pages of 8, 16 and 32 keys.  Any
other head dim must raise in all three wrappers.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_prefill as PP
from repro_torch.kernels import prefix_attention as PX

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ROW_TOL = 1e-2     # bf16: max ||got - exact|| / ||exact|| of an output row
DTYPES = [torch.float32, torch.bfloat16]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _row_err(got, exact):
    """The largest ||got - exact|| / ||exact|| over output rows; a row whose
    exact result is 0 must be exactly 0."""
    g = got.float().reshape(-1, got.shape[-1])
    e = exact.float().reshape(-1, exact.shape[-1])
    diff, norm = (g - e).norm(dim=-1), e.norm(dim=-1)
    assert not bool((diff[norm == 0] > 0).any())
    live = norm > 0
    return (diff[live] / norm[live]).max().item() if bool(live.any()) else 0.


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device=dev, dtype=dtype)


def paged_case(seed, dtype, dev):
    """A random ragged prefill chunk over a random pool, in the runtime's
    run-table contract: every segment starts on a fresh page."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 5))
    KV = int(rng.choice([1, 2]))
    R = int(rng.choice([1, 2, 7, 16]))
    hd = int(rng.choice([64, 128]))
    page = int(rng.choice([1, 5, 8, 16, 17, 32]))
    Sq = int(rng.integers(1, 161))
    window = int(rng.choice([0, 0, 24, 100]))
    cap = float(rng.choice([0.0, 30.0]))
    rows = []
    for _ in range(B):
        ql = int(rng.integers(1, Sq + 1)) if rng.random() < 0.8 else 0
        pre = [int(n) for n in rng.integers(1, 300,
                                            size=int(rng.integers(0, 3)))]
        rows.append((pre if ql else [], ql))
    n_pages = 1 + sum(-(-n // page) for pre, ql in rows for n in pre + [ql])
    free = list(rng.permutation(np.arange(1, n_pages + 1)))  # 0 = scratch
    runs = []
    for pre, ql in rows:
        t, c, s, pos = [], [], [], 0
        for n in pre + ([ql] if ql else []):
            for off in range(0, n, page):
                t.append(int(free.pop()))
                c.append(min(page, n - off))
                s.append(pos + off)
            pos += n
        runs.append((t, c, s, pos - ql))
    n_slots = max(len(r[0]) for r in runs) + 2     # trailing empty entries
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    q_start = np.array([r[3] for r in runs], np.int32)
    q_len = np.array([ql for _, ql in rows], np.int32)
    for b, (t, c, s, _) in enumerate(runs):
        tables[b, :len(t)], counts[b, :len(t)], starts[b, :len(t)] = t, c, s
    shape = (2, n_pages + 1, page, KV, hd)
    ints = [torch.from_numpy(a).to(dev)
            for a in (tables, counts, starts, q_start, q_len)]
    q = _randn(rng, (B, Sq, R * KV, hd), dtype, dev).transpose(1, 2)
    return dict(q=q, k=_randn(rng, shape, dtype, dev),
                v=_randn(rng, shape, dtype, dev), ints=ints, window=window,
                cap=cap)


def _paged(fn, c, q=None, q_start=None, q_len=None):
    tables, counts, starts, qs, ql = c["ints"]
    return fn(c["q"] if q is None else q, c["k"], c["v"], tables, counts,
              starts, qs if q_start is None else q_start,
              ql if q_len is None else q_len, 1, c["window"],
              logit_cap=c["cap"])


def prefix_case(seed, dtype, dev):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 4))
    KV = int(rng.choice([1, 2]))
    R = int(rng.choice([1, 2, 7, 16]))
    hd = int(rng.choice([64, 128]))
    P = int(rng.choice([0, int(rng.integers(1, 400))]))
    Sq = int(rng.integers(1, 300))
    q = _randn(rng, (B, Sq, R * KV, hd), dtype, dev).transpose(1, 2)
    k = _randn(rng, (B, P + Sq, KV, hd), dtype, dev).transpose(1, 2)
    v = _randn(rng, (B, P + Sq, KV, hd), dtype, dev).transpose(1, 2)
    return dict(q=q, k=k, v=v, prefix_len=P,
                window=int(rng.choice([0, 0, 24, 100])),
                logit_cap=float(rng.choice([0.0, 30.0])))


def _prefix(fn, c, **kw):
    c = dict(c, **kw)
    return fn(c.pop("q"), c.pop("k"), c.pop("v"), **c)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(12))
def test_paged_prefill_kernel_matches_plain(dev, seed, dtype):
    c = paged_case(seed, dtype, dev)
    got = _paged(PP.paged_prefill_attention, c)
    want = _paged(PP.paged_prefill_torch, c)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        exact = _paged(PP.paged_prefill_torch,
                       dict(c, q=c["q"].float(), k=c["k"].float(),
                            v=c["v"].float()))
        rel = _row_err(got, exact)
        assert rel <= ROW_TOL, rel
    q_len = c["ints"][4]
    pad = torch.arange(got.shape[2], device=dev)[None] >= q_len[:, None]
    assert bool((got.float().permute(0, 2, 1, 3)[pad] == 0).all())
    # rows from `cut` on, recomputed as a later chunk, keep their bits
    Sq = got.shape[2]
    if Sq > 1:
        cut = int(np.random.default_rng(seed + 100).integers(1, Sq))
        b = _paged(PP.paged_prefill_attention, c, q=c["q"][:, :, cut:],
                   q_start=c["ints"][3] + cut,
                   q_len=torch.clamp(q_len - cut, min=0).to(q_len.dtype))
        assert torch.equal(got[:, :, cut:], b)


def chunk_case(seed, dtype, dev):
    """A ragged prefill chunk over tables laid out as ``--reuse chunk`` lays
    out a request: each doc shared whole, relocated (an owned head of whole
    pages, then the shared tail) or computed, then the question.  The chunk
    is a piece of one computed segment, so its q_start skips the shared
    runs before it and shared runs sit in the table past it."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 5))
    KV = int(rng.choice([1, 2]))
    R = int(rng.choice([1, 2, 7]))
    hd = int(rng.choice([64, 128]))
    page = int(rng.choice([8, 16]))
    rows = []
    for _ in range(B):
        segs, pos = [], 0          # ("run" | "seg", absolute start, tokens)
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(page + 1, 200))
            kind = rng.choice(["exact", "reloc", "miss"])
            head = page * int(rng.integers(1, n // page + 1))
            if kind == "exact":
                segs.append(("run", pos, n))
            elif kind == "reloc" and head < n:
                segs += [("seg", pos, head), ("run", pos + head, n - head)]
            else:
                segs.append(("seg", pos, n))
            pos += n
        segs.append(("seg", pos, int(rng.integers(1, 40))))
        i = int(rng.choice([j for j, sg in enumerate(segs)
                            if sg[0] == "seg"]))
        off = int(rng.integers(0, segs[i][2]))
        rows.append((segs, i, off, int(rng.integers(1, segs[i][2] - off
                                                     + 1))))
    entries = []
    for segs, i, off, ql in rows:
        # computed segments after the chunk's own are not computed yet
        spans = [(abs0, n if kind == "run" or j < i else off + ql)
                 for j, (kind, abs0, n) in enumerate(segs)
                 if kind == "run" or j <= i]
        entries.append([(abs0 + o, min(page, n - o)) for abs0, n in spans
                        for o in range(0, n, page)])
    n_pages = sum(map(len, entries))
    free = list(rng.permutation(np.arange(1, n_pages + 1)))  # 0 = scratch
    n_slots = max(map(len, entries)) + 3
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    for b, row in enumerate(entries):
        for j, (st, c) in enumerate(row):
            tables[b, j], counts[b, j], starts[b, j] = free.pop(), c, st
    q_start = np.array([segs[i][1] + off for segs, i, off, _ in rows],
                       np.int32)
    q_len = np.array([r[3] for r in rows], np.int32)
    Sq = int(q_len.max())
    shape = (2, n_pages + 1, page, KV, hd)
    ints = [torch.from_numpy(a).to(dev)
            for a in (tables, counts, starts, q_start, q_len)]
    q = _randn(rng, (B, Sq, R * KV, hd), dtype, dev).transpose(1, 2)
    return dict(q=q, k=_randn(rng, shape, dtype, dev),
                v=_randn(rng, shape, dtype, dev), ints=ints,
                window=int(rng.choice([0, 0, 100])),
                cap=float(rng.choice([0.0, 30.0])))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(8))
def test_paged_prefill_kernel_on_chunk_reuse_tables(dev, seed, dtype):
    """Interleaved tables: the kernel against its plain version; the shared
    runs past the chunk's last row change no bit; rows recomputed as a
    later chunk keep their bits."""
    c = chunk_case(seed, dtype, dev)
    got = _paged(PP.paged_prefill_attention, c)
    want = _paged(PP.paged_prefill_torch, c)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        exact = _paged(PP.paged_prefill_torch,
                       dict(c, q=c["q"].float(), k=c["k"].float(),
                            v=c["v"].float()))
        rel = _row_err(got, exact)
        assert rel <= ROW_TOL, rel
    tables, counts, starts, q_start, q_len = c["ints"]
    later = starts > (q_start + q_len - 1)[:, None]
    cut_tables = dict(c, ints=[tables, counts.masked_fill(later, 0), starts,
                               q_start, q_len])
    assert torch.equal(_paged(PP.paged_prefill_attention, cut_tables), got)
    Sq = got.shape[2]
    if Sq > 1:
        cut = int(np.random.default_rng(seed + 200).integers(1, Sq))
        b = _paged(PP.paged_prefill_attention, c, q=c["q"][:, :, cut:],
                   q_start=q_start + cut,
                   q_len=torch.clamp(q_len - cut, min=0).to(q_len.dtype))
        assert torch.equal(got[:, :, cut:], b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(12))
def test_prefix_kernel_matches_plain(dev, seed, dtype):
    c = prefix_case(seed, dtype, dev)
    got = _prefix(PX.prefix_flash_attention, c)
    want = _prefix(PX.prefix_attention_torch, c)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        exact = _prefix(PX.prefix_attention_torch, c, q=c["q"].float(),
                        k=c["k"].float(), v=c["v"].float())
        rel = _row_err(got, exact)
        assert rel <= ROW_TOL, rel
    Sq = got.shape[2]
    if Sq > 1:
        cut = int(np.random.default_rng(seed + 100).integers(1, Sq))
        b = _prefix(PX.prefix_flash_attention, c, q=c["q"][:, :, cut:],
                    prefix_len=c["prefix_len"] + cut)
        assert torch.equal(got[:, :, cut:], b)


def decode_case(seed, dtype, dev):
    """A random decode batch over a random pool: row 0 spans 8 or more
    splits, the last row (B > 1) is all empty, the others are random."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 9))
    KV = int(rng.choice([1, 2]))
    R = int(rng.choice([1, 2, 7, 16]))
    hd = int(rng.choice([64, 128]))
    page = int(rng.choice([1, 5, 8, 16, 17, 32]))
    window = int(rng.choice([0, 0, 24, 100]))
    cap = float(rng.choice([0.0, 30.0]))
    rows = []
    for b in range(B):
        u = 0.0 if b == 0 else 1.0 if b == B - 1 else rng.random()
        if u < 0.3:
            rows.append([int(n) for n in rng.integers(450, 800, size=2)]
                        + [int(rng.integers(1, 30))])
        elif u < 0.85:
            rows.append([int(n) for n in rng.integers(
                1, 300, size=int(rng.integers(1, 4)))])
        else:
            rows.append([])
    n_pages = 1 + sum(-(-n // page) for segs in rows for n in segs)
    free = list(rng.permutation(np.arange(1, n_pages + 1)))  # 0 = scratch
    runs = []
    for segs in rows:
        t, c, s, pos = [], [], [], 0
        for n in segs:
            for off in range(0, n, page):
                t.append(int(free.pop()))
                c.append(min(page, n - off))
                s.append(pos + off)
            pos += n
        runs.append((t, c, s, max(pos - 1, 0)))
    n_slots = max(len(r[0]) for r in runs) + 3     # trailing empty entries
    ints = [np.zeros((B, n_slots), np.int32) for _ in range(3)]
    for b, (t, c, s, _) in enumerate(runs):
        for a, vals in zip(ints, (t, c, s)):
            a[b, :len(vals)] = vals
    qpos = np.array([r[3] for r in runs], np.int32)
    shape = (2, n_pages + 1, page, KV, hd)
    return dict(q=_randn(rng, (B, R * KV, hd), dtype, dev),
                k=_randn(rng, shape, dtype, dev),
                v=_randn(rng, shape, dtype, dev),
                ints=[torch.from_numpy(a).to(dev) for a in (*ints, qpos)],
                window=window, cap=cap, empty=[not segs for segs in rows])


def _decode(fn, c, **kw):
    c = dict(c, **kw)
    tables, counts, starts, qpos = c["ints"]
    return fn(c["q"], c["k"], c["v"], tables, counts, starts, qpos, 1,
              c["window"], logit_cap=c["cap"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(12))
def test_decode_kernel_matches_plain(dev, seed, dtype):
    c = decode_case(seed, dtype, dev)
    got = _decode(PA.paged_decode_attention, c)
    want = _decode(PA.paged_decode_torch, c)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        exact = _decode(PA.paged_decode_torch, c, q=c["q"].float(),
                        k=c["k"].float(), v=c["v"].float())
        rel = _row_err(got, exact)
        assert rel <= ROW_TOL, rel
    empty = torch.tensor(c["empty"], device=dev)
    assert bool((got.float()[empty] == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(6))
def test_decode_row_bits_depend_on_its_own_table_only(dev, seed, dtype):
    c = decode_case(100 + seed, dtype, dev)
    out = _decode(PA.paged_decode_attention, c)
    tables, counts, starts, qpos = c["ints"]
    B = out.shape[0]
    for b in range(B):
        alone = _decode(PA.paged_decode_attention, c, q=c["q"][b:b + 1],
                        ints=[t[b:b + 1] for t in c["ints"]])
        assert torch.equal(alone, out[b:b + 1]), b
        own = tables[b][counts[b] > 0].long()
        gen = torch.Generator(device=dev).manual_seed(seed * 10 + b)
        other = {}
        for n in ("k", "v"):
            t = torch.randn(c[n].shape, generator=gen, device=dev)
            t = t.to(dtype)
            t[:, own] = c[n][:, own]
            other[n] = t
        assert torch.equal(_decode(PA.paged_decode_attention, c,
                                   **other)[b], out[b]), b
    live = int((counts > 0).sum(dim=1).max())
    narrow = [t[:, :live].contiguous() for t in (tables, counts, starts)]
    wide = [torch.cat([t, torch.zeros_like(t[:, :1]).expand(-1, 200)],
                      dim=1) for t in (tables, counts, starts)]
    for ints in (narrow, wide):
        assert torch.equal(_decode(PA.paged_decode_attention, c,
                                   ints=ints + [qpos]), out)


# the paper models' head shapes: (model, KV heads, query heads per KV head,
# window); Mistral-7B also with its 4096-token window over longer rows
PAPER = [("mistral", 8, 4, 0), ("mistral", 8, 4, 4096), ("llama2", 32, 1, 0)]
PAPER_IDS = ["mistral", "mistral-window", "llama2"]


def _table(rng, rows, page):
    """Run tables for rows of segment lengths, every segment on fresh pages
    (page 0 is scratch): (tables, counts, starts, lengths, n_pages)."""
    n_pages = sum(-(-n // page) for segs in rows for n in segs)
    free = list(rng.permutation(np.arange(1, n_pages + 1)))
    runs = []
    for segs in rows:
        t, c, st, pos = [], [], [], 0
        for n in segs:
            for off in range(0, n, page):
                t.append(int(free.pop()))
                c.append(min(page, n - off))
                st.append(pos + off)
            pos += n
        runs.append((t, c, st, pos))
    n_slots = max(len(r[0]) for r in runs) + 3
    ints = [np.zeros((len(rows), n_slots), np.int32) for _ in range(3)]
    for b, r in enumerate(runs):
        for a, vals in zip(ints, r[:3]):
            a[b, :len(vals)] = vals
    return (*ints, [r[3] for r in runs], n_pages)


def _seed(KV, window, hd, page):
    return KV + window + (0 if hd == 128 else hd + page)


def paper_decode_case(KV, R, window, dtype, dev, hd=128, page=16):
    """8 rows of two docs and a question (~1,100 keys; ~4,700 under a 4096
    window, past it; a 1024 window cuts the ~1,100), the last row all
    empty."""
    rng = np.random.default_rng(_seed(KV, window, hd, page))
    docs = (2400, 2300) if window > 1100 else (600, 500)
    rows = [[docs[0] - 7 * b, docs[1] + 3 * b, 9 + b] for b in range(7)]
    tables, counts, starts, lens, n_pages = _table(rng, rows + [[]], page)
    qpos = np.array([max(n - 1, 0) for n in lens], np.int32)
    shape = (2, n_pages + 1, page, KV, hd)
    return dict(q=_randn(rng, (8, R * KV, hd), dtype, dev),
                k=_randn(rng, shape, dtype, dev),
                v=_randn(rng, shape, dtype, dev),
                ints=[torch.from_numpy(a).to(dev)
                      for a in (tables, counts, starts, qpos)],
                window=window, cap=0.0, empty=[False] * 7 + [True])


def paper_prefill_case(KV, R, window, dtype, dev, hd=128, page=16):
    """A 160-row chunk after cached docs (4,500 keys under a 4096 window;
    1,160 under a 1024 one), a shorter row, a fresh row and a padding
    row."""
    rng = np.random.default_rng(_seed(KV, window, hd, page) + 1)
    pre = (2400, 2100) if window > 1100 else (700, 300)
    rows = [(list(pre), 160), ([900], 100), ([], 130), ([], 0)]
    tables, counts, starts, lens, n_pages = _table(
        rng, [p + [ql] if ql else [] for p, ql in rows], page)
    q_len = np.array([ql for _, ql in rows], np.int32)
    q_start = np.array([n - ql for n, (_, ql) in zip(lens, rows)], np.int32)
    q_start[q_len == 0] = 0
    shape = (2, n_pages + 1, page, KV, hd)
    q = _randn(rng, (4, 160, R * KV, hd), dtype, dev).transpose(1, 2)
    return dict(q=q, k=_randn(rng, shape, dtype, dev),
                v=_randn(rng, shape, dtype, dev),
                ints=[torch.from_numpy(a).to(dev)
                      for a in (tables, counts, starts, q_start, q_len)],
                window=window, cap=0.0)


def _check_bf16_rows(got, exact, dtype):
    if dtype == torch.bfloat16:
        rel = _row_err(got, exact)
        assert rel <= ROW_TOL, rel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,KV,R,window", PAPER, ids=PAPER_IDS)
def test_decode_kernel_at_paper_shapes(dev, model, KV, R, window, dtype):
    _check_paper_decode(paper_decode_case(KV, R, window, dtype, dev), dtype)


def _check_paper_decode(c, dtype):
    got = _decode(PA.paged_decode_attention, c)
    want = _decode(PA.paged_decode_torch, c)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    _check_bf16_rows(got, _decode(PA.paged_decode_torch, c,
                                  q=c["q"].float(), k=c["k"].float(),
                                  v=c["v"].float()), dtype)
    assert bool((got.float()[7] == 0).all())
    for b in range(8):                 # each row alone, bit for bit
        alone = _decode(PA.paged_decode_attention, c, q=c["q"][b:b + 1],
                        ints=[t[b:b + 1] for t in c["ints"]])
        assert torch.equal(alone, got[b:b + 1]), b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,KV,R,window", PAPER, ids=PAPER_IDS)
def test_paged_prefill_kernel_at_paper_shapes(dev, model, KV, R, window,
                                              dtype):
    _check_paper_prefill(paper_prefill_case(KV, R, window, dtype, dev),
                         dtype, dev)


def _check_paper_prefill(c, dtype, dev):
    got = _paged(PP.paged_prefill_attention, c)
    want = _paged(PP.paged_prefill_torch, c)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    _check_bf16_rows(got, _paged(PP.paged_prefill_torch,
                                 dict(c, q=c["q"].float(), k=c["k"].float(),
                                      v=c["v"].float())), dtype)
    q_start, q_len = c["ints"][3], c["ints"][4]
    pad = torch.arange(160, device=dev)[None] >= q_len[:, None]
    assert bool((got.float().permute(0, 2, 1, 3)[pad] == 0).all())
    for cut in (1, 77, 159):           # rows as a later chunk, bit for bit
        b = _paged(PP.paged_prefill_attention, c, q=c["q"][:, :, cut:],
                   q_start=q_start + cut,
                   q_len=torch.clamp(q_len - cut, min=0).to(q_len.dtype))
        assert torch.equal(got[:, :, cut:], b), cut


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,KV,R,window", PAPER, ids=PAPER_IDS)
def test_prefix_kernel_at_paper_shapes(dev, model, KV, R, window, dtype):
    _check_paper_prefix(KV, R, window, dtype, dev)


def _check_paper_prefix(KV, R, window, dtype, dev, hd=128):
    rng = np.random.default_rng(_seed(KV, window, hd, 0) + 2)
    P, Sq = (4200, 200) if window > 1100 else (1000, 200) if window \
        else (300, 200)
    q = _randn(rng, (1, Sq, R * KV, hd), dtype, dev).transpose(1, 2)
    k = _randn(rng, (1, P + Sq, KV, hd), dtype, dev).transpose(1, 2)
    v = _randn(rng, (1, P + Sq, KV, hd), dtype, dev).transpose(1, 2)
    c = dict(q=q, k=k, v=v, prefix_len=P, window=window, logit_cap=0.0)
    got = _prefix(PX.prefix_flash_attention, c)
    want = _prefix(PX.prefix_attention_torch, c)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    _check_bf16_rows(got, _prefix(PX.prefix_attention_torch, c,
                                  q=q.float(), k=k.float(), v=v.float()),
                     dtype)
    for cut in (1, 64, 150):           # rows as a later chunk, bit for bit
        b = _prefix(PX.prefix_flash_attention, c, q=q[:, :, cut:],
                    prefix_len=P + cut)
        assert torch.equal(got[:, :, cut:], b), cut


# Gemma3-12B's heads: hd 256, 16 query heads over 8 KV heads (R 2), its
# 1024 window (which the ~1,100-key rows pass) and its global layers;
# pages of 8, 16 and 32 keys
HD256 = [(0, 8), (1024, 8), (0, 16), (1024, 16), (0, 32), (1024, 32)]
HD256_IDS = [f"win{w}-page{p}" for w, p in HD256]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,page", HD256, ids=HD256_IDS)
def test_decode_kernel_at_hd256(dev, window, page, dtype):
    _check_paper_decode(paper_decode_case(8, 2, window, dtype, dev, hd=256,
                                          page=page), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,page", HD256, ids=HD256_IDS)
def test_paged_prefill_kernel_at_hd256(dev, window, page, dtype):
    _check_paper_prefill(paper_prefill_case(8, 2, window, dtype, dev,
                                            hd=256, page=page), dtype, dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 1024])
def test_prefix_kernel_at_hd256(dev, window, dtype):
    _check_paper_prefix(8, 2, window, dtype, dev, hd=256)


@pytest.mark.parametrize("hd", [32, 96, 192, 512])
def test_kernels_refuse_other_head_dims(dev, hd):
    c = decode_case(1, torch.bfloat16, dev)
    shape = c["k"].shape[:-1] + (hd,)
    q = torch.zeros(c["q"].shape[:-1] + (hd,), dtype=torch.bfloat16,
                    device=dev)
    k = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        _decode(PA.paged_decode_attention, c, q=q, k=k, v=k)
    tables, counts, starts, _ = c["ints"]
    B = q.shape[0]
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        PP.paged_prefill_attention(q[:, :, None], k, k, tables, counts,
                                   starts, zero, zero + 1, 1, 0)
    x = torch.zeros((1, 4, 8, hd), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PX.prefix_flash_attention(x, x, x, prefix_len=0)
