"""The keyed train step at the bench preset, alone in a fresh process.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.keyed_step [--warm 5] [--out FILE] [--profile]
    PYTHONPATH=OTHER python path/to/keyed_step.py [--warm 5] [--out FILE] [--profile]   # another checkout's port

`parallel.dist.render_grads` (cover scene, 1200x800, 10 spp, depth 50,
threefry key 0, zero target) once cold and `--warm` times warm, each ended
by `torch.cuda.synchronize()`. It prints one JSON line: the cold and warm
seconds, the launch counts of all the steps, the peak memory the steps
took above what was allocated before them, and the card; with `--out` it
saves the last step's gradient (`torch.save`, CPU tensors by field); with
`--profile` it adds two more warm steps under torch.profiler
(`profiled_steps`: wall and device-busy ms a step, the idle share, the
hand-written kernels' device ms and launches traced, beside the launches
made).
It uses only names that every checkout of the port since the keyed
gradient has (`render_grads`, `scene_params`, `build.LAUNCHES`, the
presets), so run by path with another checkout first on `PYTHONPATH` it
times that checkout's step: chip_smoke.py phase 16c does so with
`--parent`, in turns with this one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# The wrappers' launch counters that a keyed step can move (any checkout
# since the keyed gradient), with the kernels one count launches.
STEP_KERNELS = {"threefry_render_kernel": 1, "threefry_replay": 1, "threefry_record": 1, "threefry_reverse": 1,
                "grad_reduce": 2}
# What the names of those kernels hold, and no other kernel's.
HAND_WRITTEN = ("threefry_", "grad_reduce_")


def profiled_steps(step, launches: dict, profiled: int = 2) -> dict:
    """`profiled` calls of `step` under torch.profiler, after a sleep kernel
    (the profiler has been seen to drop the first kernel it should trace)
    -> {"wall_ms": a step by the host clock, ended by a sync; "busy_ms": the
    device time a step of every kernel traced but the sleep; "idle": 1 -
    busy / wall; "kernel_ms", "kernel_counts": each kernel's device ms over
    its traced launches, and those launches; "launches_made", the
    hand-written kernels' launches by `launches` (the wrappers' counters);
    "launches_traced", those the profiler traced}. A launch it missed adds
    nothing to busy_ms: with fewer traced than made the idle share reads
    high, and nothing is filled in."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / profiled
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "sleep" not in e.key]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / profiled
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1.0 - busy_ms / wall_ms,
            "kernel_ms": {e.key: e.self_device_time_total / 1e3 for e in dev},
            "kernel_counts": {e.key: e.count for e in dev},
            "launches_made": sum((launches.get(k, 0) - before.get(k, 0)) * per for k, per in STEP_KERNELS.items()),
            "launches_traced": sum(e.count for e in dev if any(h in e.key for h in HAND_WRITTEN))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--out", default=None, help="save the gradient here")
    ap.add_argument("--profile", action="store_true", help="two more warm steps under torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("keyed_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    dev = torch.device("cuda", 0)
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    params = pdist.scene_params(scene)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    build.load()  # the build is not the step's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    build.reset_launches()
    seconds = []
    for _ in range(1 + args.warm):
        t0 = time.perf_counter()
        _, grads = pdist.render_grads(params, scene, cam, target, 0)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    if args.out:
        torch.save({k: v.detach().cpu() for k, v in grads.items()}, args.out)
    result = {"cold_s": seconds[0], "warm_s": seconds[1:], "launches": dict(build.LAUNCHES),
              "step_memory_gb": (torch.cuda.max_memory_allocated() - live) / 1e9, "card": smi[0] if smi else None}
    if args.profile:
        prof = profiled_steps(lambda: pdist.render_grads(params, scene, cam, target, 0), build.LAUNCHES)
        for field in ("kernel_ms", "kernel_counts"):  # the hand-written kernels'
            prof[field] = {k.split("(")[0]: v for k, v in prof[field].items() if any(h in k for h in HAND_WRITTEN)}
        result["profile"] = prof
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
