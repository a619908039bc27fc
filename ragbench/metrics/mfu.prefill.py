"""Model FLOPs of the window's prefill steps over their wall time (each
``_run_paged_rows``, ending in a synchronise) times the bf16 peak (%).
The FLOPs are the work the tokens need (roofline.prefill_flops): cached
tokens and padding are not counted, and an MoE counts its top-k experts.
Layer: model step."""
from ragbench import roofline


def read(run):
    steps = run.spans.get("prefill", [])
    wall = sum(dt for dt, _ in steps)
    if not wall:
        return None
    flops = sum(roofline.prefill_flops(run.cfg, rows) for _, rows in steps)
    return 100.0 * flops / (wall * roofline.BF16_FLOPS_PER_S)
