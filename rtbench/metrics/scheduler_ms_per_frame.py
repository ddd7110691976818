"""Device ms a frame of every operation that is not one of the port's
hand-written kernels: the lane scheduler's sorts, compaction gathers and
permutations, fills, the fold and the 8-bit output."""

from rtbench import tracing


def read(trace):
    if trace.get("backend") != "cuda" or not trace["frames"]:
        return None
    return tracing.other_seconds(trace) * 1e3 / trace["frames"]
