"""Mean TTFT (ms) over every request due in the window, each timed from
its due time; a request with no first token at the close counts its age
then.  Host clock.  The mean moves with every request's time to its first
token; the median swings between runs as requests cross from hits to
misses (PERF.md), so it is reported beside it, in the traced run."""
import numpy as np

from ragbench import record


def read(run):
    return 1e3 * float(np.mean(record.ttfts(run)))
