"""Model FLOPs of the window's decode steps over their wall time (each
``_decode``, ending in a synchronise) times the bf16 peak (%): the whole
decode step's share of the chip's peak, beside the paged decode kernel's
roofline (roofline.decode_flops counts the rows served, not the padding).
Layer: model step."""
from ragbench import roofline


def read(run):
    steps = run.spans.get("decode", [])
    wall = sum(dt for dt, _ in steps)
    if not wall:
        return None
    flops = sum(roofline.decode_flops(run.cfg, rows) for _, rows in steps)
    return 100.0 * flops / (wall * roofline.BF16_FLOPS_PER_S)
