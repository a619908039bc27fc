"""Hash the dense models' main serves of the checkout in the current
directory, on one CUDA card, so that two checkouts can be shown to serve
the same bits.

    cd <checkout> && python3 <this repository>/scripts/serve_digest.py

It builds the kernels and runs that checkout's own ``chip_smoke.py`` main
serves: Qwen2-0.5B (phase 5) and, at full published width, Mistral-7B and
LLaMA2-7B (phase 15's).  For each it prints one sha256 over every
result's request id, tokens and first-token logits bits, in request
order.  Equal lines from two checkouts mean equal tokens and bit-equal
first-token logits.
"""
import gc
import hashlib
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402  (the checkout's own script)
import numpy as np  # noqa: E402
import torch  # noqa: E402


def digest(results):
    h = hashlib.sha256()
    for r in sorted(results, key=lambda r: r.req_id):
        h.update(str((r.req_id, list(r.tokens))).encode())
        h.update(np.ascontiguousarray(r.first_logits).tobytes())
    return h.hexdigest()


def main():
    t = time.perf_counter()
    cs.phase_device(torch)
    cs.phase_build()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    out = cs.phase_serve(torch, np)
    print(f"[digest] qwen2-0.5b {digest(out[6])}", flush=True)
    del out
    for arch in cs.PAPER_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        args = serve.build_parser().parse_args(cs.paper_argv(arch, 32))
        cfg, params, corpus, idx, wl, _ = serve.make_setup(
            args, cfg=get_config(arch))
        res = cs.serve_main_path(torch, np, arch, cfg, params, corpus, idx,
                                 wl, args)[0]
        print(f"[digest] {arch} {digest(res)}", flush=True)
        del params, res
    print(f"[digest] {time.perf_counter() - t:.1f}s", flush=True)


if __name__ == "__main__":
    main()
