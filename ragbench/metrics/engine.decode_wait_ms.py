"""Mean time (ms) a decode step waits for the device once it is issued:
the program's ``engine.decode.wait`` span (the next tokens' readback and
the synchronise), over the window's unprofiled decode steps.  Layer:
model step."""
from ragbench import spans


def read(run):
    return spans.mean_of(run, "engine.decode", ("wait",))
