"""Measurements of the CUDA kernels on the card, and the helpers they share
with `chip_smoke.py`. Each probe runs as a module from the repo root and
needs one CUDA GPU with nvcc:

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.perf_probe
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.kernel_parts
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.fma_contraction
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.device_idle
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.grad_step

Nothing on the render path imports them.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
