"""Device busy and idle share of a warm render at the bench preset.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.device_idle [--reps 5]

Renders the bench preset (cover scene, 1200x800, 10 spp, depth 50) with
`render_cuda` three times to warm up, then `--reps` times under
torch.profiler. Prints the kernels with the most device time, the wall
time per render, the device-busy time per render (the sum of the device
events' times: kernels, copies and fills, each once; the host-side
operators that launched them are left out so nothing counts twice) and
the idle share, 1 - busy / wall. The wall time includes the profiler's
own overhead.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda
from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("device_idle: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    for _ in range(3):
        render_cuda(scene, cam)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render_cuda(scene, cam)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"{e.key[:60]:60s} count {e.count:4d} self_device_us {e.self_device_time_total:10.1f}")
    busy_ms = sum(e.self_device_time_total for e in events) / reps / 1e3
    print(f"wall per render {wall_ms:.3f} ms; device busy per render {busy_ms:.3f} ms; "
          f"idle share {1 - busy_ms / wall_ms:.4f} [{nvidia_smi()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
