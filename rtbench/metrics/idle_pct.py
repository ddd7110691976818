"""Device idle share of the traced window: 1 - the device events' busy
time (each kernel, copy and fill once) / the window's wall time."""


def read(trace):
    if not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
