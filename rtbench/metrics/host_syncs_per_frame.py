"""Host syncs a frame or step: the port's `rt.sync.*` spans in the traced
window (each a call that blocks the host until the card's stream drains)
÷ the frames."""

from rtbench import spans


def read(trace):
    n = spans.host_syncs(trace)
    return None if n is None else n / trace["frames"]
