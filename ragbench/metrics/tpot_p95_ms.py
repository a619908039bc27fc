"""95th percentile over requests of (last token - first token) /
(tokens - 1) (ms), a request still decoding at the close censored there.
Host clock."""
from ragbench import record


def read(run):
    xs = record.tpots(run)
    return 1e3 * record.percentile(xs, 95) if xs else None
