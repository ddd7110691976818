"""Where the time of a warm fwd+bwd train step goes, at the bench preset.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.grad_step [--reps 5]

Runs `render_grads_cuda` on the bench preset (cover scene, 1200x800,
10 spp, depth 50, zero target) with the work_hint carry: two warm-up
steps, `--reps` steps each timed alone by the host clock to a
synchronize (best and median: the step time without the profiler), then
`--reps` steps under torch.profiler. Prints the kernels with
the most device time, the device time per step by part (the forward
render, the backward's replay, its reverse walk, the reduction's chunk
kernel and its fold over chunks, the lane sorts, the rest),
the wall time per step, the device-busy time (the device events' own
times, each once) and the idle share, 1 - busy / wall, and the peak
device memory of a step. The wall time includes the profiler's overhead.
Last, the sha256 of the scene-field gradient and whether every step gave
the same bits: two builds of the backward agree bit for bit when their
digests do.
"""

from __future__ import annotations

import argparse
import hashlib
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

# Device-kernel name fragments -> part of the step (first match wins).
_PARTS = (
    ("forward render_kernel", ("render_kernel",)),
    ("backward replay grad_replay_kernel", ("grad_replay",)),
    ("backward reverse grad_reverse_kernel", ("grad_reverse",)),
    ("reduction, chunks grad_reduce_chunks", ("grad_reduce_chunks",)),
    ("reduction, fold over chunks grad_reduce_partials", ("grad_reduce_partials",)),
    ("sorts (argsort, permutations)", ("sort", "Sort", "radix", "Radix")),
)


def _part(name: str) -> str:
    for part, keys in _PARTS:
        if any(k in name for k in keys):
            return part
    return "other (packing, state, loss, copies, fills)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("grad_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    params = cg.scene_params(scene)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)

    grads = []

    def step(hint):
        (_, work), g = cg.render_grads_cuda(params, scene, cam, target, return_work=True,
                                            work_hint=hint)
        grads.append(g)
        return work

    work = step(step(None))
    torch.cuda.synchronize()
    alone = []
    for _ in range(reps):
        t0 = time.perf_counter()
        work = step(work)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    print(f"warm step alone, best / median of {reps}: {min(alone):.3f} / {statistics.median(alone):.3f} ms "
          f"[{nvidia_smi()}]")
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            work = step(work)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"{e.key[:60]:60s} count {e.count:4d} self_device_us {e.self_device_time_total:10.1f}")
    parts: dict[str, float] = {}
    for e in events:
        parts[_part(e.key)] = parts.get(_part(e.key), 0.0) + e.self_device_time_total / reps / 1e3
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {part:45s} {ms:9.3f} ms per step")
    busy_ms = sum(parts.values())
    rays = cam.num_pixels * cam.samples_per_pixel
    print(f"wall per step {wall_ms:.3f} ms ({rays / wall_ms / 1e3:.2f} Mrays/s); device busy per "
          f"step {busy_ms:.3f} ms; idle share {1 - busy_ms / wall_ms:.4f}; peak memory "
          f"{peak_gb:.3f} GB [{nvidia_smi()}]")
    flat = [torch.cat([g[k].reshape(-1) for k in cg.DIFF_FIELDS]) for g in grads]
    digest = hashlib.sha256(flat[-1].cpu().numpy().tobytes()).hexdigest()
    print(f"gradient sha256 {digest}; all {len(flat)} steps bit-identical: "
          f"{all(torch.equal(f, flat[0]) for f in flat)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
