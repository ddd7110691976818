"""The sweep's design variants on the card: its group and its register cap,
and the parent tree's kernels beside them.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.sweep_variants [--rounds 7] [--parent DIR]

Builds `csrc/` once per variant (-DRT_SWEEP_GROUP=g -DRT_SWEEP_REGS=r,
csrc/render_device.cuh; the committed build, group 8 at 64 registers,
first) and, with `--parent`, the kernels of another checkout of the port
by its own `kernels/build.py`. For each it prints the readings of the
three sweep kernels (registers, spills, blocks an SM, SASS per sphere
test: probes/sweep_readings.py) and, at the bench preset (cover scene,
1200x800, 10 spp, depth 50), by CUDA events: one render pass in pixel
order, one pass over the lanes sorted by cost (the warm schedule), and
the sweep probe at 131072 columns (64 reps); by torch.profiler (its
wrapper syncs), the backward replay on the train step's cost-sorted
lanes, all rounds in one profile. All take turns in each of `--rounds`
rounds; it prints the best and the median of each, and the SM clock and
power nvidia-smi read meanwhile. Every build's lane state, sweep-probe result and replay
records must equal the committed build's bit for bit. Needs one CUDA
GPU with nvcc.
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


def flags_of(group: int, regs: int) -> tuple:
    if (group, regs) == COMMITTED:
        return build.NVCC_FLAGS
    return (*build.NVCC_FLAGS, f"-DRT_SWEEP_GROUP={group}", f"-DRT_SWEEP_REGS={regs}")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--parent", type=Path, default=None, help="another checkout of the port, timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
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
    clocks = [float(x.split(",")[0]) for x in smi_lines if x.strip()]
    power = [float(x.split(",")[1]) for x in smi_lines if x.strip()]
    if clocks:
        print(f"while timing: SM clock min / median / max {min(clocks):.0f} / {statistics.median(clocks):.0f} / "
              f"{max(clocks):.0f} MHz, power median / max {statistics.median(power):.0f} / {max(power):.0f} W "
              f"({len(clocks)} readings) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
