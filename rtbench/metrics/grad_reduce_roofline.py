"""The reduction's share of its roofline (`grad_reduce_chunks` and
`grad_reduce_partials` together) over the traced steps: one event a
sweep."""

from rtbench import tracing, yardstick


def read(trace):
    if not trace.get("sweeps") or "paths" not in trace:
        return None
    bound = yardstick.grad_reduce_bound_s(trace["sweeps"], trace["paths"], trace["n_slots"])
    return tracing.share(bound, tracing.kernel_seconds(trace, "grad_reduce"))
