"""A whole frame's share of the card's float32 peak: the frames' sphere
tests (15 operations each on PCG streams, 16 on threefry keys, every sweep
against the active spheres) over the traced window's wall time."""

from rtbench import yardstick


def read(trace):
    if not trace.get("sweeps") or not trace["window_s"] or "backend" not in trace:
        return None
    per_test = yardstick.OPS_PER_SPHERE_TEST["keyed" if trace["backend"] == "jnp" else "pcg"]
    return 100.0 * trace["sweeps"] * trace["n_active"] * per_test / (trace["window_s"] * yardstick.PEAK_F32_OPS)
