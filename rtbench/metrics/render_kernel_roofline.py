"""`render_kernel`'s share of its roofline: the least time of the traced
frames' sweeps (each testing every active sphere) and of their passes'
lane state, over the kernel's device time."""

from rtbench import tracing, yardstick


def read(trace):
    passes = trace["launches"].get("render_kernel", 0)
    if not passes or not trace.get("sweeps"):
        return None
    bound = yardstick.render_kernel_bound_s(trace["sweeps"], trace["n_active"], trace["n_slots"],
                                            trace["pixels"], passes)
    return tracing.share(bound, tracing.kernel_seconds(trace, "render_kernel"))
