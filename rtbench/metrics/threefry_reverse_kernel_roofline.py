"""`threefry_reverse_kernel`'s share of its byte roofline over the traced
steps."""

from rtbench import tracing, yardstick


def read(trace):
    if not trace.get("sweeps") or "paths" not in trace:
        return None
    bound = yardstick.threefry_reverse_bound_s(trace["sweeps"], trace["n_slots"], trace["pixels"], trace["paths"])
    return tracing.share(bound, tracing.kernel_seconds(trace, "threefry_reverse_kernel"))
