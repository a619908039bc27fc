"""95th percentile TTFT (ms) over every request due in the window,
censored at the close as ``ttft_p50_ms``.  Host clock."""
from ragbench import record


def read(run):
    return 1e3 * record.percentile(record.ttfts(run), 95)
