"""What the per-layer metrics read from a traced window: each measured
kernel's device seconds, and the device seconds of everything else."""

from __future__ import annotations

from rtbench import yardstick

# The launch counters of `kernels/build.py` that count each measured
# kernel, and the device kernels one counted launch makes.
LAUNCH_COUNTERS = {
    "render_kernel": ("render_kernel", 1),
    "threefry_render_kernel": ("threefry_render_kernel", 1),
    "threefry_record_kernel": ("threefry_record", 1),
    "threefry_reverse_kernel": ("threefry_reverse", 1),
    "grad_reduce": ("grad_reduce", 2),
}


def _traced(trace: dict, kernel: str) -> tuple:
    """(device seconds, launches) of `kernel` that the profiler traced in
    the window, and the launches the port's wrappers counted."""
    seconds, traced = 0.0, 0
    for name, start, end in trace["device_ops"]:
        if yardstick.kernel_of(name) == kernel:
            seconds += (end - start) / 1e6
            traced += 1
    counter, per = LAUNCH_COUNTERS[kernel]
    return seconds, traced, trace["launches"].get(counter, 0) * per


def untraced_launches(trace: dict) -> dict:
    """Launches of each measured kernel that ran in the window (by the
    port's counters) and that the profiler did not trace."""
    out = {}
    for kernel in LAUNCH_COUNTERS:
        _, traced, made = _traced(trace, kernel)
        if made > traced:
            out[kernel] = made - traced
    return out


def kernel_seconds(trace: dict, kernel: str) -> float | None:
    """The device seconds of `kernel` over the traced window, or None where
    it did not run, or where the profiler dropped any of its launches (the
    count is in `untraced_launches`): nothing stands in for a launch that
    was not traced."""
    seconds, traced, made = _traced(trace, kernel)
    if traced == 0 or made == 0 or traced < made:
        return None
    return seconds


def other_seconds(trace: dict) -> float:
    """Device seconds of every operation that is none of the port's
    hand-written kernels: sorts, gathers, fills, copies, the fold."""
    return sum((end - start) / 1e6 for name, start, end in trace["device_ops"]
               if not yardstick.HAND_WRITTEN.search(name))


def share(bound_s: float | None, seconds: float | None) -> float | None:
    """A roofline share in percent, or None where either is missing."""
    if bound_s is None or not seconds:
        return None
    return 100.0 * bound_s / seconds
