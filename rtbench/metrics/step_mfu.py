"""The whole train step's share of the card's float32 peak: the forward's
sphere tests (16 operations each, every sweep against the active spheres)
over the traced window's wall time. It bounds every kernel share of the
step from above in what it counts."""

from rtbench import yardstick


def read(trace):
    if not trace.get("sweeps") or "paths" not in trace or not trace["window_s"]:
        return None
    ops = trace["sweeps"] * trace["n_active"] * yardstick.OPS_PER_SPHERE_TEST["keyed"]
    return 100.0 * ops / (trace["window_s"] * yardstick.PEAK_F32_OPS)
