"""Seconds from the process's start to the window's opening: imports,
weights, corpus and index, the kernels' build or load, the pool and the
warm-up.  Host clock."""


def read(run):
    return run.setup_s
