"""What the port's spans say of a traced window: its host syncs, and each
idle gap of the card put down to where the host was when it began.

The port records its spans (`ray_tracing_in_one_weekend_tpu_torch/utils/
spans.py`, names `rt.*`) as host events of torch.profiler, on the device
trace's clock, so they reach the readers in `trace["host_ops"]` beside
PyTorch's own operations. A gap goes by its start, as `harness.breakdown`
names one: to the innermost `rt.*` span, on any thread (the autograd
engine runs the keyed backward on a thread of its own), whose interval
holds it. A gap begun inside an `rt.sync.*` span is the sync's, inside any
other port span the port's host code's, and inside none the benchmark
client's (between and around the port's calls). The three parts add up to
`idle_pct`.

A program that records no span (a tree before the port had them) reads
nothing here, and neither does a window with no frames or no gaps.
"""

from __future__ import annotations

PREFIX = "rt."
SYNC_PREFIX = "rt.sync."


def _port_spans(trace: dict) -> list:
    return [op for op in trace["host_ops"] if op[0].startswith(PREFIX)]


def host_syncs(trace: dict) -> int | None:
    """The `rt.sync.*` spans begun in the window, or None where the window
    has nothing to read."""
    spans = _port_spans(trace)
    if not (trace["frames"] and trace["gaps"] and spans):
        return None
    return sum(1 for name, _, _ in spans if name.startswith(SYNC_PREFIX))


def idle_split(trace: dict) -> dict | None:
    """{"sync", "program", "client"}: the percent of the traced window's
    wall time that the card sat idle in gaps begun inside a sync span,
    inside another port span, or inside none; None where the window has
    nothing to read."""
    spans = sorted(_port_spans(trace), key=lambda op: op[1])
    if not (trace["frames"] and trace["gaps"] and spans):
        return None
    idle = {"sync": 0.0, "program": 0.0, "client": 0.0}
    running, nxt = [], 0
    for g0, g1 in sorted(trace["gaps"]):
        while nxt < len(spans) and spans[nxt][1] <= g0:
            running.append(spans[nxt])
            nxt += 1
        running = [op for op in running if op[2] > g0]
        if not running:
            part = "client"
        else:
            inner = min(running, key=lambda op: op[2] - op[1])[0]
            part = "sync" if inner.startswith(SYNC_PREFIX) else "program"
        idle[part] += g1 - g0
    wall_us = trace["window_s"] * 1e6
    return {part: 100.0 * us / wall_us for part, us in idle.items()}
