"""Share (%) of the window's unprofiled wall that the runtime's event
handlers (``runtime.<kind>`` spans) spend outside every engine step
(``engine.decode`` / ``engine.prefill``): committing, evicting, paginating
and scheduling between steps.  Each step ends in a synchronise, so the
device is idle there.  Layer: runtime and scheduler."""
from ragbench import spans


def read(run):
    w = spans.window(run)
    if w is None or w[1] <= 0:
        return None
    records, wall = w
    handlers = sum(s.dur_ns for s in records
                   if s.name.startswith("runtime."))
    steps = sum(s.dur_ns for s in records if s.name in spans.STEPS)
    return 100.0 * (handlers - steps) / 1e9 / wall
