"""Measurements of the CUDA kernels on the card, and the helpers they share
with `chip_smoke.py`. Each probe runs as a module from the repo root and
needs one CUDA GPU with nvcc:

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.perf_probe
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.kernel_parts
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.fma_contraction
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.device_idle
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.grad_step
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.sweep_variants [--parent DIR]
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.reduce_parts [--parent DIR]
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.cold_step [--parent DIR]
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.sweep_sched [tile:budget:passes ...]
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.keyed_grad_exact [--chunks N,...]
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.keyed_step [--warm 5] [--out FILE]

Nothing on the render path imports them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def smi_samples():
    """While open, nvidia-smi reads the SM clock (MHz) and the power draw
    (W) every 100 ms; the list it yields holds one "clock, power" line per
    reading once the block has closed."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "--loop-ms=100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    lines: list[str] = []
    try:
        yield lines
    finally:
        proc.terminate()
        lines.extend(proc.communicate(timeout=30)[0].splitlines())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` on the current stream, by CUDA events.

    A sleep kernel first keeps the device busy (~50 us per call, at about
    2 GHz) while the host queues the calls, so that for a kernel shorter
    than its wrapper's host work the events time the device, not the
    host's launch rate."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000 * reps + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, key: str, reps: int) -> float:
    """Mean device milliseconds per call of `fn()` spent in the kernels
    whose name contains `key`, by torch.profiler over `reps` calls: the
    kernel's own time, without its wrapper's host work and syncs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key]
    if not times:
        raise RuntimeError(f"the profiler saw no device kernel named like {key!r}")
    return sum(times) / reps / 1e3


def small_camera(device, spp=4, max_depth=8, width=64, **kw):
    """The small camera of the kernel checks: 64x32 at aspect 2."""
    return make_camera(image_width=width, aspect_ratio=2.0, samples_per_pixel=spp,
                       max_depth=max_depth, device=device, **kw)


# Slots of `tie_scene` that duplicate a lower slot: no tie may go to them.
TIE_DUPLICATES = (3, 5, 8, 9, 10)


def tie_scene(device="cuda"):
    """Eleven slots with exact ties, a count that is no multiple of the
    sweep's group (8, or 4): slot 3 duplicates slot 2 and slot 5 slot 1
    (inside the first group of 8), slots 8, 9 and 10 duplicate slots 4, 6
    and 7 (in the remainder), each duplicate of another material. The
    lowest index must win every tie, so no duplicate is ever hit, and the
    scene renders as `without_duplicates` of it. `tie_camera` looks at it."""
    return scene_lib.from_spheres(
        centers=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0], [-1.0, 0.0, -1.0],
                 [1.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.9, -1.5], [-0.5, -0.3, -0.6],
                 [1.0, 0.0, -1.0], [0.0, 0.9, -1.5], [-0.5, -0.3, -0.6]],
        radii=[100.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.3, 0.15, 0.5, 0.3, 0.15],
        mat_types=[0, 0, 2, 1, 1, 1, 0, 0, 0, 1, 2],
        albedos=[[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [1.0, 1.0, 1.0], [0.9, 0.1, 0.1],
                 [0.8, 0.6, 0.2], [0.2, 0.9, 0.2], [0.7, 0.3, 0.1], [0.2, 0.4, 0.9],
                 [0.3, 0.3, 0.9], [0.9, 0.9, 0.9], [1.0, 1.0, 1.0]],
        device=device,
    )


def without_duplicates(scene):
    """`scene` (a cut of `tie_scene`) with its duplicate slots inactive."""
    active = scene.active.clone()
    active[[k for k in TIE_DUPLICATES if k < active.shape[0]]] = False
    return scene.replace(active=active)


def first_slots(scene, n: int):
    """The scene's first `n` slots."""
    return scene.replace(**{f.name: getattr(scene, f.name)[:n] for f in dataclasses.fields(scene)})


def tie_camera(device="cuda"):
    """48x24, 2 spp, depth 6, looking down -z at `tie_scene`."""
    return make_camera(image_width=48, aspect_ratio=2.0, samples_per_pixel=2, max_depth=6,
                       lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0), defocus_angle_degrees=0.0,
                       device=device)


def lane_inputs(scene, cam, tile=128):
    """(packed scene [16, N], camera vector, fresh lane state sf, si, pixel
    count) for one pass over `cam`'s image on the scene's device."""
    n = cam.image_width * cam.image_height
    sf, si = cr._init_state(0, -(-n // tile) * tile, n, cam.samples_per_pixel, scene.device)
    return cr.pack_scene(scene), cr.pack_camera(cam), sf, si, n


def random_cotangent(shape, seed, device) -> torch.Tensor:
    """Standard normal float32 of `shape` from numpy's generator `seed`."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def synthetic_events(n_events, n_spheres, seed, device=None) -> torch.Tensor:
    """Backward events [E, 16] f32 in `build.grad_reverse`'s layout, from
    numpy's generator `seed`, that reach every case of the reduction:
    winners uniform over [0, n_spheres), except that 90% of chunk 1's
    events go to sphere n_spheres - 1; 10% -1 (no sphere) and 1% out of
    range (n_spheres, n_spheres + 5, -2, 2^30); cotangent words of both
    signs over six decades, 5% -0.0 and 3% +0.0; words 14-15 zero."""
    from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import CHUNK_EVENTS

    rng = np.random.default_rng(seed)
    winner = rng.integers(0, n_spheres, n_events)
    heavy = slice(CHUNK_EVENTS, 2 * CHUNK_EVENTS)
    winner[heavy] = np.where(rng.random(winner[heavy].shape) < 0.9, n_spheres - 1, winner[heavy])
    u = rng.random(n_events)
    winner = np.where(u < 0.1, -1, winner)
    winner = np.where((u >= 0.1) & (u < 0.11), rng.choice([n_spheres, n_spheres + 5, -2, 1 << 30], n_events),
                      winner)
    vals = (rng.standard_normal((n_events, 13)) * 10.0 ** rng.uniform(-3, 3, (n_events, 13))).astype(np.float32)
    v = rng.random(vals.shape)
    vals[v < 0.05] = -0.0
    vals[(v >= 0.05) & (v < 0.08)] = 0.0
    ev = np.zeros((n_events, 16), dtype=np.float32)
    ev[:, 0] = winner.astype(np.int32).view(np.float32)
    ev[:, 1:14] = vals
    return torch.from_numpy(ev).to(device)


def adjoint_errors(scene, cam, seed=0):
    """The hand-written bounce adjoint (`csrc/grad_device.cuh`) against
    torch.autograd of the plain `_bounce_f`, on every continuing bounce of
    `cam`'s image with random output cotangents -> (bounce count, relative
    L2 error of each input cotangent: o, d, att, params)."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    dev = scene.device
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    rec = cg.record_bounces(p_mat, cam_vec, seed, torch.arange(cam.num_pixels, device=dev),
                            cam.samples_per_pixel, cam.max_depth)
    m = rec["o"].shape[1]
    cot = [random_cotangent((3, m), 10 + i, dev) for i in range(3)]
    kernel = build.bounce_adjoint(p_mat.T.contiguous(), float(cam_vec[20]), rec, *cot)
    ones = torch.ones(1, m, dtype=torch.bool, device=dev)
    plain = cg._bounce_vjp(
        rec["o"], rec["d"], rec["att"], p_mat[:, rec["winner"].long()], ones, ~ones,
        (cr._u32(rec["lo"])[None], cr._u32(rec["hi"])[None]), 8 + 16 * rec["depth"].long()[None],
        float(cam_vec[20]), (*cot, torch.zeros_like(cot[0])),
    )
    names = ("o", "d", "att", "params")
    return m, {name: rel_l2(k, p) for name, k, p in zip(names, kernel, plain)}


def ptxas_summary(log: str) -> str:
    """ptxas' register, spill and shared-memory lines of an nvcc log."""
    return " ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l)
