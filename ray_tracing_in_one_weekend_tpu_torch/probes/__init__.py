"""Measurements of the CUDA kernel on the card, and the helpers they share
with `chip_smoke.py`. Each probe runs as a module from the repo root and
needs one CUDA GPU with nvcc:

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.fma_contraction
    python -m ray_tracing_in_one_weekend_tpu_torch.probes.device_idle

Nothing on the render path imports them.
"""

from __future__ import annotations

import subprocess

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
    """Mean milliseconds of `fn()` on the current stream, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def ptxas_summary(log: str) -> str:
    """ptxas' register, spill and shared-memory lines of an nvcc log."""
    return " ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l)
