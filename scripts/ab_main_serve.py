"""Time the main serve of a dense model at published width and depth on one
CUDA card, as chip_smoke.py's phases 15 and 21-23 serve it, with the port
of the source tree given, so that two trees compare in one run.

    python3 scripts/ab_main_serve.py --src SRC --arch gemma3-12b \
        [--gpu-cache-bytes N] [--reps 2]

``SRC`` is a tree's ``src`` directory (this checkout's, or an older
commit's unpacked beside it).  The seeded weights (seed 0) and the main
trace (200 docs of 512 tokens, top 2, 16 requests of 8 new tokens, decode
batches of 8, prefill batches of 4, the paper models' tiers: GPU 7.5 GiB
unless given, host 512 MiB) are built, 2 requests are served to warm the
kernels up, then the 16 are served ``--reps`` times, each through a new
runtime.  Prints one JSON line: the arch, the tree, tokens/s of each rep
(generated tokens over the host-clock wall of the serve, ending in a
device synchronise), and the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--gpu-cache-bytes", type=int, default=8_053_063_680)
    ap.add_argument("--reps", type=int, default=2)
    opts = ap.parse_args()
    sys.path.insert(0, opts.src)
    import contextlib
    import io

    import torch
    from repro_torch.launch import serve

    argv = ["--docs", "200", "--doc-tokens", "512", "--top-k", "2",
            "--requests", "16", "--max-new-tokens", "8", "--max-batch", "8",
            "--max-prefill-bs", "4", "--gpu-cache-bytes",
            str(opts.gpu_cache_bytes), "--device", "cuda", "--full-size",
            "--arch", opts.arch, "--host-cache-bytes", str(512 * 2**20)]
    args = serve.build_parser().parse_args(argv)
    cfg, params, corpus, idx, wl, _ = serve.make_setup(args)
    rates = []
    with contextlib.redirect_stdout(io.StringIO()):
        serve.serve_continuous(cfg, params, corpus, idx, wl[:2], args)
        for _ in range(opts.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, rts = serve.serve_continuous(cfg, params, corpus, idx, wl,
                                              args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rates.append(sum(len(r.tokens) for r in res) / wall)
            del rts
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps({"arch": opts.arch, "src": opts.src,
                      "tokens_per_s": rates, "card": card}))


if __name__ == "__main__":
    main()
