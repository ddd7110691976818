"""The backward's reduction on the card: its two kernels timed apart, and
the parent tree's pair beside them, on the train step's own events at
full width.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.reduce_parts [--rounds 7] [--parent DIR]

Makes the events of one train step at the bench preset (cover scene,
1200x800, 10 spp, depth 50: the step's work map and cost-sorted lanes,
`grad_replay` then `grad_reverse`) and reads them: the share of events
with no sphere, and the most events one sphere takes in one chunk (median
and maximum over chunks), the serial floor of the fixed order. Then it
builds `csrc/` and, with `--parent`, the kernels of another checkout of
the port by its own `kernels/build.py`; prints each build's registers and
spills of both kernels (ptxas) and this build's chunk kernel's blocks an
SM; requires each build's result to equal `_reduce_events_ordered`'s bit
for bit; and times each build's `grad_reduce` in turns, `--rounds`
rounds: the pair by CUDA events, each kernel apart by torch.profiler,
with the SM clock and power nvidia-smi read meanwhile. Each pair time is
also given as a share of two bounds (`reduce_bounds_ms`). Needs one CUDA
GPU with nvcc.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms, nvidia_smi, random_cotangent, smi_samples
from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings as sr
from ray_tracing_in_one_weekend_tpu_torch.probes.sweep_variants import Build
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

KERNELS = ("grad_reduce_chunks", "grad_reduce_partials")


def step_events(scene, cam, dev):
    """The events of one train step at `cam`'s shapes: the forward's work
    map, the step's cost-sorted lanes (a random radiance cotangent: the
    slots and winners do not depend on it), the replay and the reverse."""
    n = cam.num_pixels
    _, work = cr.render_cuda(scene, cam, return_work=True)
    work = work.reshape(-1)
    pix, g = cg._bwd_lanes(work, random_cotangent((3, n), 3, dev), cam.samples_per_pixel, cg.DEFAULT_BWD_TILE)
    table, cam_vec = cr.pack_scene(scene).T.contiguous(), cr.pack_camera(cam)
    replay = build.grad_replay(table, cam_vec, (0, 0, 0, n), pix, work, cg.DEFAULT_BWD_TILE,
                               cam.samples_per_pixel, cam.max_depth)
    return build.grad_reverse(table, cam_vec, replay, g, cg.DEFAULT_BWD_TILE)


def event_stats(events, n_spheres) -> dict:
    """The share of events with no sphere (-1), and over chunks the median
    and the maximum of the most events one sphere takes in the chunk."""
    w = events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    n_chunks = -(-w.numel() // cg.CHUNK_EVENTS)
    valid = (w >= 0) & (w < n_spheres)
    chunk = torch.arange(w.numel(), device=w.device) // cg.CHUNK_EVENTS
    key = chunk * (n_spheres + 1) + torch.where(valid, w, n_spheres)
    counts = torch.bincount(key, minlength=n_chunks * (n_spheres + 1)).view(n_chunks, n_spheres + 1)
    heaviest = counts[:, :n_spheres].max(1).values.double()
    return {"events": w.numel(), "chunks": n_chunks, "no_sphere_share": float((w == -1).double().mean()),
            "with_sphere": int(valid.sum()), "heaviest_median": float(heaviest.median()),
            "heaviest_max": int(heaviest.max())}


def pair_times(builds: list[Build], events, n_spheres, rounds) -> dict:
    """Per build label, lists over `rounds` rounds in turns: "pair" (ms of
    one `grad_reduce` by CUDA events, 3 calls), then "chunks" and
    "partials" (each kernel's device ms by torch.profiler, one call a
    build a round, in the same turns: the k-th kernel of a name on the
    device timeline is build k % len(builds)'s)."""
    times = {b.label: {"pair": [], "chunks": [], "partials": []} for b in builds}
    for _ in range(rounds):
        for b in builds:
            with b.on():
                times[b.label]["pair"].append(cuda_ms(lambda: b.mod.grad_reduce(events, n_spheres), reps=3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for b in builds:
                with b.on():
                    b.mod.grad_reduce(events, n_spheres)
        torch.cuda.synchronize()
    for name, part in zip(KERNELS, ("chunks", "partials")):
        found = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name),
                       key=lambda e: e.time_range.start)
        if len(found) != rounds * len(builds):
            raise RuntimeError(f"the profile holds {len(found)} {name} kernels, not {rounds * len(builds)}")
        for k, e in enumerate(found):
            times[builds[k % len(builds)].label][part].append(e.time_range.elapsed_us() / 1e3)
    return times


def reduce_bounds_ms(n_events, n_with_sphere, n_spheres):
    """The reduction's least times, each `kp.bound_ms`'s (ms, "bytes" or
    "operations"), against 13 adds an event with a sphere and the [16, N]
    result written once: (what this run's events need, every event read
    whole). An event is two 32-byte sectors, words 0-7 and 8-15; an event
    with no sphere (a winner outside [0, N)) needs only the first, which
    holds its winner, so it counts 32 bytes and the others 64. The second
    bound counts 64 bytes for every event, the reads the kernel makes."""
    out = 4.0 * 16 * n_spheres
    need = kp.bound_ms(13.0 * n_with_sphere, 64.0 * n_with_sphere + 32.0 * (n_events - n_with_sphere) + out)
    whole = kp.bound_ms(13.0 * n_with_sphere, 64.0 * n_events + out)
    return need, whole


def resources_line(log: str) -> str:
    res = sr.ptxas_resources(log)
    parts = []
    for kernel in KERNELS:
        r = next((v for k, v in res.items() if k.startswith(f"_Z{len(kernel)}{kernel}")), None)
        parts.append(f"{kernel} {r.registers} registers, spills {r.spill_stores + r.spill_loads} B"
                     if r else f"{kernel} not reported")
    return "; ".join(parts)


def builds(parent: Path | None, n_spheres: int) -> list[Build]:
    """This tree's build, then the parent's; prints their readings."""
    res = build.build()
    blocks = build.blocks_per_sm("grad_reduce_chunks", 256, n_spheres)
    print(f"this tree: {resources_line(res.log)}; grad_reduce_chunks blocks per SM at {n_spheres} "
          f"spheres: {blocks} (CUDA runtime)", flush=True)
    out = [Build("this tree", build)]
    if parent is not None:
        mod = sr.load_build(parent)
        res = mod.build()
        print(f"parent {parent}: {resources_line(res.log)}", flush=True)
        out.append(Build(f"parent {parent}", mod))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--parent", type=Path, default=None, help="another checkout of the port, timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("reduce_parts: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    n_spheres = cr.pack_scene(scene).shape[1]
    events = step_events(scene, cam, dev)
    stats = event_stats(events, n_spheres)
    print(f"events {stats['events']} in {stats['chunks']} chunks of {cg.CHUNK_EVENTS}; no sphere "
          f"{stats['no_sphere_share']:.4f}; the most events one sphere takes in a chunk: median "
          f"{stats['heaviest_median']:.0f}, max {stats['heaviest_max']}", flush=True)
    all_builds = builds(args.parent.resolve() if args.parent else None, n_spheres)
    want = cg._reduce_events_ordered(events, n_spheres).view(torch.int32)
    for b in all_builds:
        with b.on():
            if not torch.equal(b.mod.grad_reduce(events, n_spheres).view(torch.int32), want):
                raise RuntimeError(f"{b.label}: grad_reduce differs from _reduce_events_ordered")
    del want
    need, whole = (b[0] for b in reduce_bounds_ms(stats["events"], stats["with_sphere"], n_spheres))
    with smi_samples() as smi_lines:
        times = pair_times(all_builds, events, n_spheres, args.rounds)
    for b in all_builds:
        t = times[b.label]
        parts = "; ".join(f"{k} {min(v):.4f} / {statistics.median(v):.4f} ms" for k, v in t.items())
        print(f"{b.label}: best / median of {args.rounds} rounds: {parts}; pair at "
              f"{need / min(t['pair']):.1%} of the bound of the bytes its events need, {need:.4f} ms, and at "
              f"{whole / min(t['pair']):.1%} of the bound of every event read whole, {whole:.4f} ms; "
              f"bit-identical to _reduce_events_ordered [{smi}]", flush=True)
    clocks = [float(x.split(",")[0]) for x in smi_lines if x.strip()]
    power = [float(x.split(",")[1]) for x in smi_lines if x.strip()]
    if clocks:
        print(f"while timing: SM clock min / median / max {min(clocks):.0f} / {statistics.median(clocks):.0f} / "
              f"{max(clocks):.0f} MHz, power median / max {statistics.median(power):.0f} / {max(power):.0f} W "
              f"({len(clocks)} readings) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
