"""Mean host time (ms) issuing a decode step: the program's
``engine.decode.pack`` (the run tables) plus ``engine.decode.launch``
(the step's launches) spans, over the window's unprofiled decode steps
(``ragbench/spans.py``).  Layer: model step."""
from ragbench import spans


def read(run):
    return spans.mean_of(run, "engine.decode", ("pack", "launch"))
