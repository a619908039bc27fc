"""Share (%) of the window's unprofiled wall spent in the knowledge tree's
tier copies: the program's ``tree.demote``, ``tree.promote``,
``tree.spill`` and ``tree.fetch`` spans.  Layer: knowledge tree."""
from ragbench import spans


def read(run):
    w = spans.window(run)
    if w is None or w[1] <= 0:
        return None
    records, wall = w
    return 100.0 * sum(s.dur_ns for s in records
                       if s.name in spans.TIERS) / 1e9 / wall
