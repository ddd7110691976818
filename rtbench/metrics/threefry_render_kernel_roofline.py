"""`threefry_render_kernel`'s share of its roofline over the traced
frames."""

from rtbench import tracing, yardstick


def read(trace):
    if not trace.get("sweeps"):
        return None
    bound = yardstick.threefry_render_bound_s(trace["sweeps"], trace["n_active"], trace["n_slots"],
                                              trace["pixels"] * trace["frames"])
    return tracing.share(bound, tracing.kernel_seconds(trace, "threefry_render_kernel"))
