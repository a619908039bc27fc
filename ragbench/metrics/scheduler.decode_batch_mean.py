"""Mean rows of the window's decode iterations (the benchmark's wrapper
around the runtime's ``_decode``).  Layer: runtime and scheduler."""


def read(run):
    xs = [len(rows) for _, rows in run.spans.get("decode", [])]
    return sum(xs) / len(xs) if xs else None
