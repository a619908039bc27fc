"""Sum of the least times of the paged prefill kernel's launches over their
device time, in the profiled part of the window (%).  Layer: kernels
(csrc/paged_prefill.cu)."""


def read(run):
    t = run.trace
    if not t or not t["kernel_s"]["prefill"]:
        return None
    return 100.0 * t["bound_s"]["prefill"] / t["kernel_s"]["prefill"]
