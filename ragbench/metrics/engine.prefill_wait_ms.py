"""Mean time (ms) a prefill iteration waits for the device once it is
issued: the program's ``engine.prefill.wait`` span (the first tokens'
readback and the synchronise), over the window's unprofiled prefill
iterations.  Layer: model step."""
from ragbench import spans


def read(run):
    return spans.mean_of(run, "engine.prefill", ("wait",))
