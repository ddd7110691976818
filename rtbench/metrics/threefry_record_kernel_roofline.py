"""`threefry_record_kernel`'s share of its roofline over the traced steps
(the sweeps from the port's count of each step's recording)."""

from rtbench import tracing, yardstick


def read(trace):
    if not trace.get("sweeps") or "paths" not in trace:
        return None
    bound = yardstick.threefry_record_bound_s(trace["sweeps"], trace["n_active"], trace["n_slots"],
                                              trace["pixels"], trace["paths"])
    return tracing.share(bound, tracing.kernel_seconds(trace, "threefry_record_kernel"))
