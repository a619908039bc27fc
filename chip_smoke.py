#!/usr/bin/env python3
"""Drive the PyTorch port's RAGCache main path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, each fatal on failure:
  1. device  — require CUDA, print the card's name and power limit, TF32 off;
  2. build   — compile every CUDA kernel from src/repro_torch/kernels/csrc;
  3. parity  — each kernel against its plain PyTorch version (and the dense
               oracle) at the main path's shapes and at small edge cases;
  4. times   — CUDA-event medians of kernel, plain version and a PyTorch
               library yardstick, beside the card's least possible time;
  5. serve   — the main path at full Qwen2-0.5B width (seeded random bf16
               weights): 32 requests through ContinuousRuntime, counting
               kernel launches;
  6. check   — the first 8 requests again on a fresh runtime through the
               plain versions, compared under first-token-logit tolerance;
               then unchunked vs 128-token prefill chunks through the
               kernels (bit-identical or not, and by how much);
  7. profile — torch.profiler over 8 more requests: device time by kernel.

The last stdout line is {"ok": true, "device": {...}}; the line before it is
the kernels' JSON record.  Without CUDA, or outside a checkout of the
repository, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version on identical inputs: f32 outputs differ only by
# summation order; bf16 outputs, compared in f32, by at most a few bf16 ulps
# of values below ~2 (one ulp there is 2**-7 ~ 7.8e-3)
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
# full-path cross-checks, bf16 through 24 layers: first-token logits of two
# runs that differ only in arithmetic order (kernel vs plain attention, or
# the GEMM shapes of another chunk split).  |logits| reach ~3, where a bf16
# ulp is 1.6e-2; the first run on the card measured 7.4e-2 between the
# kernel and the plain path, and 0.15 leaves twice that
LOGIT_EPS = 0.15
MAIN_ARGV = ["--docs", "200", "--doc-tokens", "512", "--top-k", "2",
             "--requests", "32", "--max-new-tokens", "8", "--max-batch", "8",
             "--max-prefill-bs", "4", "--gpu-cache-bytes", "805306368",
             "--device", "cuda"]


def die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# run-table inputs
# ---------------------------------------------------------------------------

def build_runs(seg_lens, page, free_pages):
    """Run tables for a sequence of segments, each starting in a fresh page
    (the runtime's contract): lists of page ids, counts and start positions."""
    tables, counts, starts = [], [], []
    pos = 0
    for n in seg_lens:
        for off in range(0, n, page):
            tables.append(int(free_pages.pop()))
            counts.append(min(page, n - off))
            starts.append(pos + off)
        pos += n
    return tables, counts, starts, pos


def pool(torch, L, n_pages, page, KV, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (L, n_pages, page, KV, hd)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return k, v


def decode_case(torch, np, *, B, H, KV, hd, page, n_slots, rows, dtype,
                seed, L=2, layer=1, window=0, cap=0.0):
    """rows[b] is a list of segment lengths (empty = an all-empty row)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + sum(-(-n // page) for segs in rows for n in segs) + 8
    free = list(rng.permutation(np.arange(1, n_pages)))    # 0 = scratch
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    qpos = np.zeros((B,), np.int32)
    for b, segs in enumerate(rows):
        t, c, s, total = build_runs(segs, page, free)
        assert len(t) <= n_slots, (len(t), n_slots)
        tables[b, :len(t)], counts[b, :len(t)], starts[b, :len(t)] = t, c, s
        qpos[b] = max(total - 1, 0)
    k, v = pool(torch, L, n_pages, page, KV, hd, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dict(q=q, k_pages=k, v_pages=v, tables=dev(tables),
                counts=dev(counts), starts=dev(starts), qpos=dev(qpos),
                layer=layer, window=window, logit_cap=cap)


def prefill_case(torch, np, *, B, H, KV, hd, page, n_slots, Sq, rows, dtype,
                 seed, L=2, layer=1, window=0, cap=0.0):
    """rows[b] = (cached prefix segment lengths, q_len); q_len == 0 is a
    padding row.  The chunk's own pages follow the prefix's."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + sum(-(-n // page) for pre, ql in rows
                      for n in list(pre) + [ql]) + 8
    free = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    q_start = np.zeros((B,), np.int32)
    q_len = np.zeros((B,), np.int32)
    for b, (pre, ql) in enumerate(rows):
        if ql == 0:
            continue
        t, c, s, total = build_runs(list(pre) + [ql], page, free)
        assert len(t) <= n_slots, (len(t), n_slots)
        tables[b, :len(t)], counts[b, :len(t)], starts[b, :len(t)] = t, c, s
        q_start[b], q_len[b] = total - ql, ql
    k, v = pool(torch, L, n_pages, page, KV, hd, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda").to(dtype)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dict(q=q, k_pages=k, v_pages=v, tables=dev(tables),
                counts=dev(counts), starts=dev(starts), q_start=dev(q_start),
                q_len=dev(q_len), layer=layer, window=window, logit_cap=cap)


def call(fn, case):
    c = dict(case)
    layer, window = c.pop("layer"), c.pop("window")
    cap = c.pop("logit_cap")
    args = list(c.values())
    return fn(*args, layer, window, logit_cap=cap)


# ---------------------------------------------------------------------------
# bounds, times
# ---------------------------------------------------------------------------

def visible_pairs(np, case, decode: bool):
    """(query, key) pairs the masks leave visible, summed over rows, and the
    live key tokens the kernel must read."""
    counts = case["counts"].cpu().numpy()
    starts = case["starts"].cpu().numpy()
    page = case["k_pages"].shape[2]
    window = case["window"]
    slot = np.arange(page)
    live = slot[None, None] < counts[..., None]            # (B, n, page)
    kpos = starts[..., None] + slot[None, None]
    pairs = 0
    if decode:
        qpos = case["qpos"].cpu().numpy()
        vis = live.copy()
        if window:
            vis &= kpos > qpos[:, None, None] - window
        pairs = int(vis.sum())
        keys = int(live.sum())
        return pairs, keys
    q_start = case["q_start"].cpu().numpy()
    q_len = case["q_len"].cpu().numpy()
    keys = 0
    for b in range(counts.shape[0]):
        if q_len[b] == 0:
            continue
        kp = kpos[b][live[b]]
        qp = q_start[b] + np.arange(q_len[b])
        vis = kp[None] <= qp[:, None]
        if window:
            vis &= kp[None] > qp[:, None] - window
        pairs += int(vis.sum())
        keys += int((kp <= qp[-1]).sum())
    return pairs, keys


def bound_ms(np, case, decode: bool):
    """Least time for the work: each input read once, each output written
    once, over the memory rate; the QK and PV products over the bf16 peak."""
    q = case["q"]
    H, hd = q.shape[1], q.shape[-1]
    KV = case["k_pages"].shape[3]
    es = q.element_size()
    pairs, keys = visible_pairs(np, case, decode)
    n_int = sum(case[n].numel() for n in ("tables", "counts", "starts"))
    byts = 2 * q.numel() * es + 2 * keys * KV * hd * es + 4 * n_int
    flops = 4 * pairs * (H // KV) * KV * hd
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, *, reps=21, warm=3, flush=None):
    """Median of `reps` CUDA-event timings of fn(), L2 flushed before each
    (the serving pool is far larger than the 50 MB L2)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def sdpa_inputs(torch, case, decode: bool):
    """Contiguous K/V and a boolean mask for one
    F.scaled_dot_product_attention call computing the same function (the
    gather is done here, outside the timed call)."""
    q = case["q"]
    B = q.shape[0]
    page = case["k_pages"].shape[2]
    counts = case["counts"].cpu().numpy()
    nb = int((counts > 0).sum(axis=1).max())
    tables = case["tables"][:, :nb].long()
    kl = case["k_pages"][case["layer"]][tables]            # (B, nb, page, KV, hd)
    vl = case["v_pages"][case["layer"]][tables]
    S = nb * page
    k = kl.reshape(B, S, *kl.shape[3:]).transpose(1, 2).contiguous()
    v = vl.reshape(B, S, *vl.shape[3:]).transpose(1, 2).contiguous()
    slot = torch.arange(page, device="cuda")
    cnt = case["counts"][:, :nb]
    live = (slot[None, None] < cnt[..., None]).reshape(B, S)
    kpos = (case["starts"][:, :nb, None] + slot[None, None]).reshape(B, S)
    if decode:
        mask = live[:, None, None, :]
        qq = q[:, :, None]
    else:
        Sq = q.shape[2]
        qpos = case["q_start"][:, None] + torch.arange(Sq, device="cuda")
        mask = live[:, None] & (kpos[:, None] <= qpos[..., None])
        mask = mask[:, None]
        qq = q
    return qq, k, v, mask


def library_fn(torch, case, decode: bool):
    import torch.nn.functional as F
    qq, k, v, mask = sdpa_inputs(torch, case, decode)
    try:
        F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qq, k, v, attn_mask=mask, enable_gqa=True)
    except (TypeError, RuntimeError):   # no GQA support: repeat the heads
        R = qq.shape[1] // k.shape[1]
        kr = k.repeat_interleave(R, dim=1)
        vr = v.repeat_interleave(R, dim=1)
        return lambda: F.scaled_dot_product_attention(qq, kr, vr,
                                                      attn_mask=mask)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        die(f"no src/repro_torch beside {Path(__file__).name}: run it from "
            f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"{torch.cuda.get_device_name(0)}, power limit not read ({e})"
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {', '.join(_build.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def check(torch, name, got, want, tol, zero_rows=None):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    zeros_ok = True
    if zero_rows is not None:
        zeros_ok = bool((got.float()[zero_rows] == 0).all())
    print(f"[parity] {name}: max_abs_err {err:.3e} (tol {tol:g})"
          f"{'' if zero_rows is None else ', padding exact 0: ' + str(zeros_ok)}",
          flush=True)
    if not (err <= tol and finite and zeros_ok):
        die(f"parity {name}: err {err} finite {finite} zeros {zeros_ok}")
    return err


def main_cases(torch, np):
    rng = np.random.default_rng(7)

    def doc():
        return int(np.clip(rng.lognormal(np.log(512), 0.4), 16, 1400))

    dec = decode_case(torch, np, B=8, H=14, KV=2, hd=64, page=16,
                      n_slots=220, dtype=torch.bfloat16, seed=11,
                      rows=[[doc(), doc(), 8 + int(rng.integers(1, 9))]
                            for _ in range(8)])
    pre = {
        2048: prefill_case(torch, np, B=4, H=14, KV=2, hd=64, page=16,
                           n_slots=220, Sq=2048, dtype=torch.bfloat16,
                           seed=12, rows=[([], 2048), ([700], 1500),
                                          ([900, 800], 300), ([], 0)]),
        64: prefill_case(torch, np, B=4, H=14, KV=2, hd=64, page=16,
                         n_slots=220, Sq=64, dtype=torch.bfloat16, seed=13,
                         rows=[([800, 1000], 64), ([1200], 40), ([], 24),
                               ([], 0)]),
    }
    return dec, pre


def phase_parity(torch, np):
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import ref
    dec, pre = main_cases(torch, np)
    errs = {}
    errs["decode"] = check(torch, "decode main B=8 H=14 KV=2 hd=64 slots=220",
                           call(PA.paged_decode_attention, dec),
                           call(PA.paged_decode_torch, dec), TOL_BF16)
    for sq, case in pre.items():
        pad = torch.arange(sq, device="cuda")[None] >= case["q_len"][:, None]
        pad = pad[:, None, :].expand(-1, case["q"].shape[1], -1)
        errs[f"prefill{sq}"] = check(
            torch, f"prefill main B=4 H=14 Sq={sq}",
            call(PP.paged_prefill_attention, case),
            call(PP.paged_prefill_torch, case), TOL_BF16, zero_rows=pad)
    # edge cases: GQA widths, head dims, empty / padded rows, mid-block
    # tails, window + softcap, f32 against the dense oracle
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for R, hd, window, cap in ((1, 64, 0, 0.0), (2, 64, 0, 0.0),
                                   (7, 64, 0, 0.0), (7, 128, 0, 0.0),
                                   (16, 128, 0, 0.0), (7, 64, 24, 30.0)):
            H, tag = 2 * R, f"{str(dtype)[6:]} R={R} hd={hd} win={window} cap={cap}"
            d = decode_case(torch, np, B=3, H=H, KV=2, hd=hd, page=16,
                            n_slots=12, dtype=dtype, seed=R + hd,
                            rows=[[20, 13, 5], [], [16, 40]],
                            window=window, cap=cap)
            got = call(PA.paged_decode_attention, d)
            check(torch, f"decode {tag}", got,
                  call(PA.paged_decode_torch, d), tol, zero_rows=[1])
            if dtype == torch.float32:
                check(torch, f"decode-oracle {tag}", got,
                      call(ref.reference_paged_decode, d), tol)
            p = prefill_case(torch, np, B=3, H=H, KV=2, hd=hd, page=16,
                             n_slots=12, Sq=40, dtype=dtype, seed=R + hd + 1,
                             rows=[([20, 13], 40), ([], 17), ([], 0)],
                             window=window, cap=cap)
            pad = torch.arange(40, device="cuda")[None] >= p["q_len"][:, None]
            pad = pad[:, None, :].expand(-1, H, -1)
            got = call(PP.paged_prefill_attention, p)
            check(torch, f"prefill {tag}", got,
                  call(PP.paged_prefill_torch, p), tol, zero_rows=pad)
            if dtype == torch.float32:
                check(torch, f"prefill-oracle {tag}", got,
                      call(ref.reference_paged_prefill, p), tol)
    return dec, pre, errs


def phase_times(torch, np, dec, pre, errs):
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name, fn, plain, case, decode, key in (
            ("paged_decode_attention", PA.paged_decode_attention,
             PA.paged_decode_torch, dec, True, "decode"),
            ("paged_prefill_attention", PP.paged_prefill_attention,
             PP.paged_prefill_torch, pre[2048], False, "prefill2048"),
            ("paged_prefill_attention@Sq=64", PP.paged_prefill_attention,
             PP.paged_prefill_torch, pre[64], False, "prefill64")):
        ms = time_ms(torch, lambda: call(fn, case), flush=flush)
        plain_ms = time_ms(torch, lambda: call(plain, case), flush=flush)
        lib = library_fn(torch, case, decode)
        lib_ms = time_ms(torch, lib, flush=flush)
        bnd, by = bound_ms(np, case, decode)
        q = case["q"]
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bnd, bound_by=by, max_abs_err=errs[key],
                         shape=f"q {tuple(q.shape)} {str(q.dtype)[6:]}, "
                               f"pool {tuple(case['k_pages'].shape)}, "
                               f"slots {case['tables'].shape[1]}")
        print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by})",
              flush=True)
    del flush
    return rows


def phase_serve(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(MAIN_ARGV)
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    cfg, params, corpus, idx, wl = serve.make_setup(args, cfg=cfg)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    PA.paged_decode_attention.launches = 0
    PP.paged_prefill_attention.launches = 0
    PA.paged_decode_torch.calls = 0
    PP.paged_prefill_torch.calls = 0
    t0 = time.perf_counter()
    results, rt = serve.serve_continuous(cfg, params, corpus, idx, wl, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": PA.paged_decode_attention.launches,
                "paged_prefill_attention":
                    PP.paged_prefill_attention.launches}
    plain = PA.paged_decode_torch.calls + PP.paged_prefill_torch.calls
    n_tok = sum(len(r.tokens) for r in results)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {len(results)} requests, {n_tok} tokens in {wall:.2f}s "
          f"wall = {n_tok / wall:.1f} tokens/s", flush=True)
    print(f"[serve] peak device memory {peak} B ({peak / 2**30:.2f} GiB); "
          f"pool blocks {rt.store.pool.n_blocks}", flush=True)
    print(f"[serve] kernel launches {launches}; plain-version calls {plain}",
          flush=True)
    if len(results) != len(wl) or any(len(r.tokens) != args.max_new_tokens
                                      for r in results):
        die("not every request was served in full")
    if min(launches.values()) <= 0:
        die(f"a kernel of the main path never launched: {launches}")
    if plain:
        die(f"the plain versions ran {plain} times on the main path")
    for r in results:
        fl = r.first_logits
        if fl is None or fl.shape != (cfg.vocab_size,) \
                or not np.isfinite(fl).all():
            die(f"request {r.req_id}: first-token logits missing, misshapen "
                f"or not finite")
    rt.tree.check_invariants()
    live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
    tree_blocks = sum(len(n.payload_gpu.blocks) for n in rt.tree.nodes()
                      if n.in_gpu and n.payload_gpu is not None)
    if live != tree_blocks + 1:
        die(f"pool leak: {live} live blocks, tree {tree_blocks} + scratch")
    return cfg, params, corpus, idx, wl, args, results, launches


def phase_check(torch, np, cfg, params, corpus, idx, wl, args, results):
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    before = (PA.paged_decode_attention.launches,
              PP.paged_prefill_attention.launches)
    sub = sorted(wl, key=lambda r: r.req_id)[:8]
    econf = dataclasses.replace(EngineConfig.from_args(args),
                                attn_impl="torch")
    t0 = time.perf_counter()
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device="cuda")
    plain = {r.req_id: r for r in rt.serve(sub,
                                           max_new_tokens=args.max_new_tokens)}
    torch.cuda.synchronize()
    after = (PA.paged_decode_attention.launches,
             PP.paged_prefill_attention.launches)
    if after != before:
        die("the plain-version runtime launched a kernel")
    by_id = {r.req_id: r for r in results}
    worst, same, bad = 0.0, 0, []
    for rid, b in plain.items():
        a = by_id[rid]
        linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                   - b.first_logits.astype(np.float64))))
        worst = max(worst, linf)
        same += list(a.tokens) == list(b.tokens)
        # logits must agree within eps; tokens then agree under the tol:
        # semantics (equal, or first-token logits within eps)
        if linf > LOGIT_EPS:
            bad.append((rid, list(a.tokens), list(b.tokens), linf))
    print(f"[check] {len(plain)} requests through the plain versions in "
          f"{time.perf_counter() - t0:.1f}s: first-token logits max L-inf "
          f"{worst:.4e} (eps {LOGIT_EPS}), tokens identical for {same}/"
          f"{len(plain)}", flush=True)
    if bad:
        die(f"kernel path and plain path disagree: {bad}")


def phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args):
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[:8]
    runs = []
    for chunk in (0, 128):
        econf = dataclasses.replace(EngineConfig.from_args(args),
                                    prefill_chunk=chunk)
        rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                               device="cuda")
        runs.append({r.req_id: r for r in
                     rt.serve(sub, max_new_tokens=args.max_new_tokens)})
    a, b = runs
    bitwise = all(np.array_equal(a[i].first_logits, b[i].first_logits)
                  for i in a)
    linf = max(float(np.max(np.abs(a[i].first_logits.astype(np.float64)
                                   - b[i].first_logits.astype(np.float64))))
               for i in a)
    same = sum(a[i].tokens == b[i].tokens for i in a)
    print(f"[chunk-split] prefill_chunk 0 vs 128 through the kernels: "
          f"first-token logits bit-identical {bitwise}, max L-inf "
          f"{linf:.4e} (eps {LOGIT_EPS}), tokens identical {same}/{len(a)}",
          flush=True)
    if linf > LOGIT_EPS:
        die(f"chunk split moved first-token logits by {linf}")


def phase_profile(torch, cfg, params, corpus, idx, wl, args):
    """Device time by kernel over a short serve (8 requests on a fresh
    runtime, under torch.profiler), beside the wall time of the same serve
    on another fresh runtime without the profiler: their ratio is the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[8:16]

    def serve_once():
        rt = ContinuousRuntime(cfg, params, corpus, idx,
                               config=EngineConfig.from_args(args),
                               device="cuda")
        t0 = time.perf_counter()
        rt.serve(sub, max_new_tokens=args.max_new_tokens)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), rt.metrics.summary()

    wall_ms, summ = serve_once()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_once()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if getattr(e, "device_type", None) == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    if not rows:
        print("[profile] device time: not measured (the profiler recorded "
              "no kernels)", flush=True)
        return
    busy = sum(r[0] for r in rows)
    print(f"[profile] 8 requests: wall {wall_ms:.1f} ms unprofiled "
          f"({summ['prefill_iterations']} prefill / "
          f"{summ['decode_iterations']} decode iterations), device busy "
          f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}% of it", flush=True)
    for ms, n, name in rows[:12]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<6d} "
              f"{name[:80]}", flush=True)


def main() -> None:
    import torch
    phase_device(torch)
    import numpy as np
    phase_build()
    dec, pre, errs = phase_parity(torch, np)
    times = phase_times(torch, np, dec, pre, errs)
    del dec, pre
    torch.cuda.empty_cache()
    (cfg, params, corpus, idx, wl, args, results,
     launches) = phase_serve(torch, np)
    phase_check(torch, np, cfg, params, corpus, idx, wl, args, results)
    phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args)
    phase_profile(torch, cfg, params, corpus, idx, wl, args)
    kernels = []
    for name, src, replaces, key in (
            ("paged_decode_attention", "src/repro_torch/kernels/csrc/"
             "paged_decode.cu", "src/repro/kernels/paged_attention.py:142",
             "decode"),
            ("paged_prefill_attention", "src/repro_torch/kernels/csrc/"
             "paged_prefill.cu", "src/repro/kernels/paged_prefill.py:155",
             "prefill2048")):
        row = times[key]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": row["max_abs_err"],
                 "max_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "shape": row["shape"]}
        if key == "prefill2048":
            entry["at_sq64"] = times["prefill64"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
