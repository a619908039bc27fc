"""Median host time (ms) of one ``staged_search`` of the IVF index the
runtime is handed, every stage included (the benchmark's wrapper around
the index, over the window).  Layer: retrieval (retrieval/vectordb.py)."""
from ragbench import record


def read(run):
    xs = run.spans.get("search_s")
    return 1e3 * record.percentile(xs, 50) if xs else None
