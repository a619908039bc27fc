"""Median TTFT (ms) over every request due in the window, each timed from
its due time; a request with no first token at the close counts its age
then.  Host clock (the paced runtime's wall clock)."""
from ragbench import record


def read(run):
    return 1e3 * record.percentile(record.ttfts(run), 50)
