"""Requests due in the window that finished by the close within both the
cell's TTFT and TPOT limits, over the window's seconds (req/s).  Host
clock.  It moves in steps of one request over the window, and most runs of
a cell read the same step, so it is reported per layer (PERF.md)."""
from ragbench import record


def read(run):
    return record.good(run) / run.close
