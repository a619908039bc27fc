"""Mean wall time (ms) of the window's decode steps: the runtime's
``_decode``, the paged decode step and its device synchronise.  Layer:
model step (models/model.py)."""


def read(run):
    xs = [dt for dt, _ in run.spans.get("decode", [])]
    return 1e3 * sum(xs) / len(xs) if xs else None
