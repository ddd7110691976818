"""`render_kernel` launches a frame (the lane scheduler's passes), from the
port's launch counter."""


def read(trace):
    n = trace["launches"].get("render_kernel", 0)
    return n / trace["frames"] if n and trace["frames"] else None
