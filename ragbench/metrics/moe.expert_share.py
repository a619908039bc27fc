"""Device time of the kernels launched under the expert span (each
expert's ``swiglu`` in ``layers.moe_dense``) over all device time in the
profiled part of the window (%).  Layer: MoE FFN."""


def read(run):
    t = run.trace
    if not t or not t["expert_s"] or not t["device_s"]:
        return None
    return 100.0 * t["expert_s"] / t["device_s"]
