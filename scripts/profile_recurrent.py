"""Device time of a recurrent family's cold sequential serve on one CUDA
card, by kernel.

    python3 scripts/profile_recurrent.py [--arch hymba-1.5b] [--requests 1]

From the repository root.  It builds the kernels, seeds the weights of
``--arch`` (``hymba-1.5b`` or ``xlstm-1.3b``) at full published width and
depth, and serves the first ``--requests`` requests of ``chip_smoke.py``'s
main trace through the sequential ``RAGServer`` twice on fresh servers:
once for the wall, once under ``torch.profiler``.  It prints the device's
busy share of that wall, the kernel launches, the top kernels, and the
prefix kernel's and cuBLAS's shares of device time.  The profiler's
post-processing takes about a minute a request (~10^5 launches each:
the recurrent scans step one token at a time), which is why
``chip_smoke.py`` does not run it.
"""
import argparse
import gc
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402  (the checkout's own script)
import torch  # noqa: E402


def profile_sequential(cfg, params, corpus, idx, sub, args, tag):
    """Device time by kernel over a cold sequential serve of ``sub`` under
    torch.profiler, beside the same serve's wall without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import RAGServer

    def serve_once():
        gc.collect()
        srv = RAGServer(cfg, params, corpus, idx,
                        config=EngineConfig.from_args(args), device="cuda")
        t0 = time.perf_counter()
        srv.serve(sub, max_new_tokens=args.max_new_tokens)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    wall_ms = serve_once()
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
        cs.die(f"[{tag}] the profiler recorded no kernels")
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"[{tag}] {len(sub)} requests: wall {wall_ms:.1f} ms unprofiled, "
          f"device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f}% of it "
          f"over {launches} kernel launches", flush=True)
    for ms, n, name in rows[:10]:
        print(f"[{tag}]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<7d} "
              f"{name[:80]}", flush=True)
    pre = sum(r[0] for r in rows if "prefix_attention" in r[2])
    gemm = sum(r[0] for r in rows if cs.GEMM_KERNEL.search(r[2]))
    print(f"[{tag}] prefix kernel {pre:.2f} ms = {100 * pre / busy:.1f}%, "
          f"cuBLAS GEMMs {gemm:.2f} ms = {100 * gemm / busy:.1f}% of "
          f"device time", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=cs.HYBRID_ARCH,
                    choices=[cs.HYBRID_ARCH, cs.XLSTM_ARCH])
    ap.add_argument("--requests", type=int, default=1)
    opts = ap.parse_args()
    t = time.perf_counter()
    cs.phase_device(torch)
    cs.phase_build()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(opts.arch)
    billed = 4 if cfg.family == "ssm" else (
        2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * cfg.tdtype.itemsize)
    args = serve.build_parser().parse_args(
        cs.recurrent_argv(opts.arch, billed))
    params = cs.model_setup_only(torch, cfg, opts.arch)
    corpus, idx, wl, _ = serve.make_data(args, cfg)
    sub = sorted(wl, key=lambda r: r.req_id)[:opts.requests]
    profile_sequential(cfg, params, corpus, idx, sub, args,
                       f"{opts.arch} profile")
    print(f"[profile] {time.perf_counter() - t:.1f}s", flush=True)


if __name__ == "__main__":
    main()
