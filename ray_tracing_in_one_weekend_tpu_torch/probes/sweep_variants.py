"""The sweep's design variants on the card: its group and its register cap,
and the parent tree's kernels beside them.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.sweep_variants [--rounds 7] [--parent DIR]

The PCG kernels: builds `csrc/` once per variant
(-DRT_SWEEP_GROUP=g -DRT_SWEEP_REGS=r, csrc/render_device.cuh; the
committed build, group 8 at 64 registers, first) and, with `--parent`,
the kernels of another checkout of the port by its own
`kernels/build.py`. For each it prints the readings of the three sweep
kernels (registers, spills, blocks an SM, SASS per sphere test:
probes/sweep_readings.py) and, at the bench preset (cover scene,
1200x800, 10 spp, depth 50), by CUDA events: one render pass in pixel
order, one pass over the lanes sorted by cost (the warm schedule), and
the sweep probe at 131072 columns (64 reps); by torch.profiler (its
wrapper syncs), the backward replay on the train step's cost-sorted
lanes, all rounds in one profile. Every build's lane state, sweep-probe
result and replay records must equal the committed build's bit for bit.

Then the jnp backend's `threefry_render_kernel`: builds it at
groups 8 and 4 and register caps 64, 72, 80 and 96
(-DRT_THREEFRY_GROUP=g -DRT_THREEFRY_REGS=r; the committed build, group
8 at 72, first) and, with `--parent`, the parent's, prints each one's
reading and times the whole bench image through each by CUDA events.
Every build's image and work map must equal the committed build's bit
for bit.

Then the keyed train step's recording forward, `threefry_record_kernel`:
builds it at register caps 80 and 72 (-DRT_THREEFRY_RECORD_REGS=r; the
committed cap 80 first), prints each one's reading and times
the whole bench image through each by CUDA events, and the reverse walk
on each one's arena, beside the committed `threefry_render_kernel`. Every
build's image and work map must be the forward's bits, and its path
counts, records in logical order (`cuda_threefry.records_in_logical_order`)
and events the committed build's.

`--parts` picks the parts (default all three: sweep, keyed, record).
All builds take turns in each of `--rounds` rounds; it prints the best
and the median of each, and the SM clock and power nvidia-smi read
meanwhile. Needs one CUDA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
import sys
from pathlib import Path
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops import threefry
from ray_tracing_in_one_weekend_tpu_torch.probes import (
    cuda_ms,
    lane_inputs,
    nvidia_smi,
    random_cotangent,
    smi_samples,
)
from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings as sr
from ray_tracing_in_one_weekend_tpu_torch.probes.fma_contraction import built_with
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

COMMITTED = (8, 64)
# (group, register cap): the committed design and the caps above 64 (255:
# none), one test at a time, groups of 4 and of 16.
VARIANTS = (COMMITTED, (8, 72), (8, 80), (8, 255), (1, 64), (4, 64), (4, 80), (16, 64), (16, 80))
# Shared memory a sphere of the parent's sweep table: the whole packed row.
PARENT_TABLE_BYTES = 64
# The keyed kernel's (group, register cap): the committed design first.
KEYED_COMMITTED = (8, 72)
KEYED_VARIANTS = (KEYED_COMMITTED, *((g, r) for g in (8, 4) for r in (64, 72, 80, 96) if (g, r) != KEYED_COMMITTED))
# The recording forward's register caps: the committed one first.
RECORD_VARIANTS = (80, 72)


def flags_of(group: int, regs: int, keyed: bool = False) -> tuple:
    if (group, regs) == (KEYED_COMMITTED if keyed else COMMITTED):
        return build.NVCC_FLAGS
    prefix = "RT_THREEFRY" if keyed else "RT_SWEEP"
    return (*build.NVCC_FLAGS, f"-D{prefix}_GROUP={group}", f"-D{prefix}_REGS={regs}")


@dataclasses.dataclass
class Build:
    label: str
    mod: object  # a kernels/build.py module
    lib: object = None  # this tree's library of the variant, bound into `mod` while on

    def on(self):
        return mock.patch.object(self.mod, "_LIB", self.lib) if self.lib else contextlib.nullcontext()


def builds(parent: Path | None) -> list[Build]:
    """Every variant's build, then the parent's; prints their readings."""
    out = []
    for v in VARIANTS:
        with built_with(flags_of(*v)) as res:
            for r in sr.readings(res.log, res.path, sr.TABLE_BYTES,
                                 lambda k: build.blocks_per_sm(k, sr.TILE, sr.N_SLOTS)):
                print(f"group {v[0]}, cap {v[1]}: {r.line()}", flush=True)
            out.append(Build(f"group {v[0]}, cap {v[1]}", build, build._LIB))
    if parent is not None:
        mod = sr.load_build(parent)
        res = mod.build()
        for r in sr.readings(res.log, res.path, PARENT_TABLE_BYTES):
            print(f"parent {parent}: {r.line()}", flush=True)
        out.append(Build(f"parent {parent}", mod))
    return out


def keyed_builds(parent: Path | None) -> list[Build]:
    """Every keyed variant's build, then the parent's; prints their readings."""
    out = []
    for v in KEYED_VARIANTS:
        with built_with(flags_of(*v, keyed=True)) as res:
            r = sr.threefry_reading(res.log, res.path, lambda k: build.blocks_per_sm(k, sr.TILE, sr.N_SLOTS))
            print(f"keyed group {v[0]}, cap {v[1]}: {r.line()}", flush=True)
            out.append(Build(f"keyed group {v[0]}, cap {v[1]}", build, build._LIB))
    if parent is not None:
        mod = sr.load_build(parent)
        res = mod.build()
        print(f"keyed parent {parent}: {sr.threefry_reading(res.log, res.path).line()}", flush=True)
        out.append(Build(f"keyed parent {parent}", mod))
    return out


def record_builds() -> list[Build]:
    """Every register cap of the recording forward; prints their readings."""
    out = []
    for regs in RECORD_VARIANTS:
        flags = build.NVCC_FLAGS if regs == RECORD_VARIANTS[0] else (*build.NVCC_FLAGS,
                                                                      f"-DRT_THREEFRY_RECORD_REGS={regs}")
        with built_with(flags) as res:
            r = sr.threefry_reading(res.log, res.path, lambda k: build.blocks_per_sm(k, sr.TILE, sr.N_SLOTS),
                                    kernel="threefry_record_kernel")
            print(f"record cap {regs}: {r.line()}", flush=True)
            out.append(Build(f"record cap {regs}", build, build._LIB))
    return out


def smi_summary(smi_lines, smi) -> str:
    clocks = [float(x.split(",")[0]) for x in smi_lines if x.strip()]
    power = [float(x.split(",")[1]) for x in smi_lines if x.strip()]
    if not clocks:
        return f"while timing: no nvidia-smi reading [{smi}]"
    return (f"while timing: SM clock min / median / max {min(clocks):.0f} / {statistics.median(clocks):.0f} / "
            f"{max(clocks):.0f} MHz, power median / max {statistics.median(power):.0f} / {max(power):.0f} W "
            f"({len(clocks)} readings) [{smi}]")


def sweep_part(args, dev, smi) -> None:
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    spp, depth, n = cam.samples_per_pixel, cam.max_depth, cam.num_pixels
    p_mat, cam_vec, sf, si, _ = lane_inputs(scene, cam)
    table = p_mat.T.contiguous()
    pixel = (cam_vec, (0, 0, 0, spp * depth), sf, si, cr.DEFAULT_TILE, spp, depth)
    sweep_args = kp.inputs("sweep_probe", kp.FILL_TILE, dev)
    all_builds = builds(args.parent.resolve() if args.parent else None)
    ref_build = all_builds[0]

    with ref_build.on():
        ref = build.render_pass(table, *pixel)
        perm = cr._perm_from_hint(ref[0][cr._SF_WORK]).reshape(2, -1)[0]
        warm = (cam_vec, pixel[1], sf[:, perm].contiguous(), si[:, perm].contiguous(), *pixel[4:])
        ref_warm = build.render_pass(table, *warm)
        ref_sweep = build.sweep_probe(*sweep_args, 64, cr.T_MIN_EPS)
        # The train step's replay: its work map, its cost-sorted lanes.
        _, work = cr.render_cuda(scene, cam, return_work=True)
        work = work.reshape(-1)
        pix, _ = cg._bwd_lanes(work, random_cotangent((3, n), 3, dev), spp, cg.DEFAULT_BWD_TILE)
        replay = (table, cam_vec, (0, 0, 0, n), pix, work, cg.DEFAULT_BWD_TILE, spp, depth)
        ref_records = build.grad_replay(*replay).records.view(torch.int32)
    for b in all_builds:
        with b.on():
            for got, want in ((b.mod.render_pass(table, *pixel), ref), (b.mod.render_pass(table, *warm), ref_warm)):
                if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                        and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"{b.label}: lane state differs from the committed build's")
            if not torch.equal(b.mod.sweep_probe(*sweep_args, 64, cr.T_MIN_EPS), ref_sweep):
                raise RuntimeError(f"{b.label}: sweep probe differs from the committed build's")
            if not torch.equal(b.mod.grad_replay(*replay).records.view(torch.int32), ref_records):
                raise RuntimeError(f"{b.label}: replay records differ from the committed build's")
    del ref_records

    times = {b.label: {"pixel": [], "warm": [], "sweep": [], "replay": []} for b in all_builds}
    with smi_samples() as smi_lines:
        for _ in range(args.rounds):
            for b in all_builds:
                t = times[b.label]
                with b.on():
                    t["pixel"].append(cuda_ms(lambda: b.mod.render_pass(table, *pixel), reps=3))
                    t["warm"].append(cuda_ms(lambda: b.mod.render_pass(table, *warm), reps=3))
                    t["sweep"].append(cuda_ms(lambda: b.mod.sweep_probe(*sweep_args, 64, cr.T_MIN_EPS), reps=5))
        # The replays in the same turns, under one profile: the k-th replay
        # kernel on the device timeline is round k // len(all_builds)'s.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.rounds):
                for b in all_builds:
                    with b.on():
                        b.mod.grad_replay(*replay)
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and "grad_replay_kernel" in e.name),
                     key=lambda e: e.time_range.start)
    if len(kernels) != args.rounds * len(all_builds):
        raise RuntimeError(f"the profile holds {len(kernels)} replay kernels, not {args.rounds * len(all_builds)}")
    for k, e in enumerate(kernels):
        times[all_builds[k % len(all_builds)].label]["replay"].append(e.time_range.elapsed_us() / 1e3)
    for b in all_builds:
        parts = "; ".join(f"{k} {min(ts):.4f} / {statistics.median(ts):.4f} ms" for k, ts in times[b.label].items())
        print(f"{b.label}: best / median of {args.rounds} rounds: pixel-order pass, warm pass, sweep probe at "
              f"{kp.FILL_TILE} columns, replay: {parts}; bit-identical to the committed build [{smi}]", flush=True)
    print(smi_summary(smi_lines, smi), flush=True)


def keyed_part(args, dev, smi) -> None:
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    table = cr.pack_scene(scene).T.contiguous()
    cam_vec = cr.pack_camera(cam).to(dev)
    pix = torch.arange(cam.num_pixels, dtype=torch.int32, device=dev)
    key = threefry.as_key(0)
    render = (table, cam_vec, pix, key, 0, cam.samples_per_pixel, cam.max_depth)
    all_builds = keyed_builds(args.parent.resolve() if args.parent else None)
    with all_builds[0].on():
        ref, ref_work = build.threefry_render(*render, work=True)
    for b in all_builds:
        with b.on():
            got, got_work = b.mod.threefry_render(*render, work=True)
            if not (torch.equal(got, ref) and torch.equal(got_work, ref_work)):
                raise RuntimeError(f"{b.label}: image or work map differs from the committed build's")
    times = {b.label: [] for b in all_builds}
    with smi_samples() as smi_lines:
        for _ in range(args.rounds):
            for b in all_builds:
                with b.on():
                    times[b.label].append(cuda_ms(lambda: b.mod.threefry_render(*render), reps=3))
    for b in all_builds:
        ts = times[b.label]
        print(f"{b.label}: bench image (1200x800, 10 spp, depth 50) best / median of {args.rounds} rounds "
              f"{min(ts):.4f} / {statistics.median(ts):.4f} ms; image and work map bit-identical to the "
              f"committed build [{smi}]", flush=True)
    print(smi_summary(smi_lines, smi), flush=True)


def record_part(args, dev, smi) -> None:
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct

    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    n, spp = cam.num_pixels, cam.samples_per_pixel
    table = cr.pack_scene(scene).T.contiguous()
    cam_vec = cr.pack_camera(cam).to(dev)
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    render = (table, cam_vec, pix, threefry.as_key(0), 0, spp, cam.max_depth)
    ref, ref_work = build.threefry_render(*render, work=True)
    g = (2.0 * ref / ref.numel()).T.contiguous() / spp  # the zero-target loss's cotangent of one sample
    all_builds = record_builds()
    ref_tables = ref_records = ref_events = None
    recs = {}
    for b in all_builds:
        with b.on():
            out, work, rec = build.threefry_record(*render)
            rec = build.complete_recording(rec, int(rec.total))
            slots, n_events = build.path_slots(pix, rec.path_count, spp, 0, n)
            n_events = int(n_events)
            events = build.threefry_reverse(rec, slots, n_events, g, int(rec.total))
        if not (torch.equal(out, ref) and torch.equal(work, ref_work)):
            raise RuntimeError(f"{b.label}: image or work map differs from threefry_render_kernel's")
        records = ct.records_in_logical_order(rec, slots, n_events).view(torch.int32)[:, :14]
        if ref_records is None:
            ref_tables, ref_records, ref_events = rec.path_count, records, events
        elif not (torch.equal(rec.path_count, ref_tables) and torch.equal(records, ref_records)
                  and torch.equal(events.view(torch.int32), ref_events.view(torch.int32))):
            raise RuntimeError(f"{b.label}: path counts, records or events differ from the committed build's")
        recs[b.label] = (rec, slots, n_events, int(rec.total))
        del records, events
    times = {b.label: ([], []) for b in all_builds}
    forward = []
    with smi_samples() as smi_lines:
        for _ in range(args.rounds):
            forward.append(cuda_ms(lambda: build.threefry_render(*render, work=True), reps=3))
            for b in all_builds:
                rec, slots, n_events, total = recs[b.label]
                with b.on():
                    times[b.label][0].append(cuda_ms(lambda: build.threefry_record(*render), reps=3))
                    times[b.label][1].append(cuda_ms(lambda: build.threefry_reverse(rec, slots, n_events, g, total),
                                                     reps=3))
    print(f"threefry_render_kernel: bench image (1200x800, 10 spp, depth 50) best / median of {args.rounds} rounds "
          f"{min(forward):.4f} / {statistics.median(forward):.4f} ms [{smi}]", flush=True)
    for label, (rt, rv) in times.items():
        print(f"{label}: bench image best / median of {args.rounds} rounds {min(rt):.4f} / {statistics.median(rt):.4f} "
              f"ms, its reverse {min(rv):.4f} / {statistics.median(rv):.4f} ms ({ref_records.shape[0]} sweeps); "
              f"image, work map, path counts, records and events bit-identical "
              f"[{smi}]", flush=True)
    print(smi_summary(smi_lines, smi), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--parent", type=Path, default=None, help="another checkout of the port, timed beside")
    ap.add_argument("--parts", default="sweep,keyed,record", help="comma-separated: sweep, keyed, record")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    parts = {"sweep": sweep_part, "keyed": keyed_part, "record": record_part}
    for name in args.parts.split(","):
        parts[name](args, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
