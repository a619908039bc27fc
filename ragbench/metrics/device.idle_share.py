"""Share (%) of the profiled part of the window in which no operation ran
on the device: 1 - the union of the device's op intervals over the
interval.  Layer: device (H100)."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
