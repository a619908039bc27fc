"""Sum of the least times of the paged decode kernel's launches over their
device time (its splits and their merge), in the profiled part of the
window (%).  Layer: kernels (csrc/paged_decode.cu)."""


def read(run):
    t = run.trace
    if not t or not t["kernel_s"]["decode"]:
        return None
    return 100.0 * t["bound_s"]["decode"] / t["kernel_s"]["decode"]
