"""Perf probe: dry-run one (arch x shape) on fake H100 cards and print its
per-card figures and its largest transfers (counterpart of
``repro.launch.perf_probe``, the hypothesis-forming tool).

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch yi-34b \\
        --shape prefill_32k [--multi] [--opt attn-fallback] [--top 15]

It prints, for data replica 0's controller and its busiest shard: FLOPs,
product bytes, bytes into the card by collective kind, bytes out, the
peak of live storage and the kernel calls; then the largest transfers
between two cards (``op_analysis.top_collectives``: by device pair, where
the reference's go by HLO op).  See ``launch/dryrun.py`` for how the
mesh is covered.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, op_analysis


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--opt", action="append", default=[],
                    choices=dryrun.OPTS)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    cfg, lay = dryrun.apply_opts(get_config(args.arch), args.opt)
    pods = 2 if args.multi else 1
    mesh = dryrun.fake_mesh(16 * pods, 16, pods)
    tally, wall = dryrun.analyze_case(cfg, args.shape, mesh, lay)
    row = mesh.replica(0).devices
    shard = max(row[1:], key=lambda d: tally.cards.get(
        d, op_analysis.Totals()).flops) if len(row) > 1 else row[0]
    print(f"{args.arch} {args.shape} on {mesh.shape} (fake cards; "
          f"{wall:.1f}s)")
    for name, dev in (("controller", row[0]), ("busiest shard", shard)):
        t = tally.cards.get(dev, op_analysis.Totals())
        print(f"{name} {dev}: flops/card={t.flops:.3e}  "
              f"dot_bytes={t.dot_bytes:.3e}  bytes_in={t.bytes_in:.3e}  "
              f"bytes_out={t.bytes_out:.3e}  peak={t.peak_bytes / 2**30:.2f} "
              f"GiB  kernels={t.kernels}")
        for k, v in t.coll.items():
            print(f"  {k:20s} {v:.3e}")
    print("--- top transfers (bytes, kind, cards x copies) ---")
    for nb, kind, meta in op_analysis.top_collectives(tally, args.top):
        print(f"{nb:12.3e}  {kind:18s} {meta}")


if __name__ == "__main__":
    main()
