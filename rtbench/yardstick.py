"""The benchmark's yardstick: published peaks of one NVIDIA H100, the least
time a kernel could take on given work, and the operations and bytes each
measured kernel's work needs.

Frozen copies of the port's arithmetic (`probes/kernel_parts.bound_ms`
and its constants, the keyed step's record and reverse byte counts of
`chip_smoke.py` phase 16c, `probes/reduce_parts.reduce_bounds_ms`), kept
here so that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# float32 operations a ray-sphere test: the PCG sweep (unit directions) and
# the keyed sweep (directions not unit; -2 (o.c) taken once a ray).
OPS_PER_SPHERE_TEST = {"pcg": 15, "keyed": 16}

# The port's packed scene row count, lane-state rows and camera vector.
P_ROWS, SF_ROWS, SI_ROWS, CAM_LEN = 16, 16, 8, 24
LANE_TILE = 128


def bound_s(ops: float, n_bytes: float) -> float:
    """The least seconds the card could take: the larger of `ops` float32
    operations at the peak and `n_bytes` at the peak bandwidth."""
    return max(ops / PEAK_F32_OPS, n_bytes / PEAK_BYTES)


def _table_bytes(n_slots: int) -> float:
    return 4.0 * (P_ROWS * n_slots + CAM_LEN)


def render_kernel_bound_s(sweeps: float, n_active: int, n_slots: int, n_pixels: int, passes: int) -> float:
    """`render_kernel` over a frame: every sweep tests the active spheres
    (15 operations each); each pass reads and writes the lane state of
    every padded lane once and reads the scene table."""
    lanes = -(-n_pixels // LANE_TILE) * LANE_TILE
    state = 4.0 * (SF_ROWS + SI_ROWS) * lanes
    return bound_s(sweeps * n_active * OPS_PER_SPHERE_TEST["pcg"], passes * (_table_bytes(n_slots) + 2 * state))


def threefry_render_bound_s(sweeps: float, n_active: int, n_slots: int, n_pixels: int) -> float:
    """`threefry_render_kernel`: 16 operations a test of an active sphere;
    the pixel ids in, the radiance out."""
    return bound_s(sweeps * n_active * OPS_PER_SPHERE_TEST["keyed"], _table_bytes(n_slots) + 4.0 * n_pixels * (1 + 3))


def threefry_record_bound_s(sweeps: float, n_active: int, n_slots: int, n_pixels: int, paths: int) -> float:
    """`threefry_record_kernel`: the forward's sweep; pixel ids in, radiance
    and work out, one 64-byte record a sweep, each path's count and last
    slot."""
    return bound_s(sweeps * n_active * OPS_PER_SPHERE_TEST["keyed"],
                   _table_bytes(n_slots) + n_pixels * 20.0 + 64.0 * sweeps + 12.0 * paths)


def threefry_reverse_bound_s(sweeps: float, n_slots: int, n_pixels: int, paths: int) -> float:
    """`threefry_reverse_kernel`: the radiance cotangent in, each path's
    slot, count and last slot, at least one 32-byte sector of each record
    (which paths reached the sky, whose records are read whole, is not
    observable from the step), and one 64-byte event a sweep out."""
    return bound_s(0.0, _table_bytes(n_slots) + 12.0 * n_pixels + 20.0 * paths + 32.0 * sweeps + 64.0 * sweeps)


def grad_reduce_bound_s(events: float, paths: int, n_slots: int) -> float:
    """`grad_reduce_chunks` + `grad_reduce_partials`: 13 adds and 64 bytes
    an event with a sphere, 32 bytes one without, the [16, N] result
    written once. A path ends at the sky at most once, so at least
    events - paths events have a sphere."""
    with_sphere = max(events - paths, 0.0)
    return bound_s(13.0 * with_sphere, 64.0 * with_sphere + 32.0 * (events - with_sphere) + 4.0 * 16 * n_slots)


# The port's hand-written kernels, by the names a device trace gives them.
HAND_WRITTEN = re.compile(r"(render_kernel|threefry_\w+_kernel|grad_\w+|bounce_adjoint_kernel|chain_fma_kernel|"
                          r"fma_peak_kernel|\w+_probe_kernel)")
KERNELS = {
    "render_kernel": re.compile(r"(?<![a-z_])render_kernel"),
    "threefry_render_kernel": re.compile(r"threefry_render_kernel"),
    "threefry_record_kernel": re.compile(r"threefry_record_kernel"),
    "threefry_reverse_kernel": re.compile(r"threefry_reverse_kernel"),
    "grad_reduce": re.compile(r"grad_reduce_(chunks|partials)"),
}


def kernel_of(name: str) -> str | None:
    """The measured kernel a device event's name belongs to, if any."""
    for kernel, pattern in KERNELS.items():
        if pattern.search(name):
            return kernel
    return None
