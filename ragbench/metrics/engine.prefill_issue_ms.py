"""Mean host time (ms) issuing a prefill iteration: the program's
``engine.prefill.plan`` (planning, promotions included), ``.pack`` and
``.launch`` spans, over the window's unprofiled prefill iterations that
launched a step.  Layer: model step."""
from ragbench import spans


def read(run):
    return spans.mean_of(run, "engine.prefill", ("plan", "pack", "launch"))
