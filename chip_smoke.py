"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from
`ray_tracing_in_one_weekend_tpu_torch/csrc/` with nvcc (into the ignored
`build/kernels/`), checks each against its plain PyTorch version on the
card, and drives the port's three paths at the bench preset (the cover
scene, 1200x800, 10 spp, depth 50) through the kernels: the render CLI
with its lane scheduler, the fwd+bwd train step of inverse rendering, and
the occupancy and roofline probes.

Phases, one line each; any failure raises and the script exits non-zero
without the result lines:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: nvcc, timed, with ptxas' register report;
3. kernel vs plain, one pass from identical lane state (64x32, spp 4,
   depth 8, tile 128, the reference cover scene): at most 2% flipped
   lanes, 256-lane block-mean MAD < 0.02 and mean difference < 0.01;
4. sky only (every sphere inactive) equal to the plain version to 1e-6,
   and NaN-as-miss: rays aimed away from every sphere all see the sky;
5. n_passes=3, budget=3 bit-identical to one pass;
6. the main path: the CLI at full width through the kernel (launch count
   > 0, P3 header, finite pixels, render seconds and Mrays/s; the timed
   render is the warm one, a hit of the schedule cache); the kernel
   against the plain version at the main path's shapes (times; the lane
   states must be bit-identical, as the build without FMA contraction
   makes them); and the 150x100 CLI render against the plain version
   (bit-identical, and block means as in phase 3);
7. the gradient path (`ops/cuda_grad.py`, `csrc/grad_kernel.cu`):
   a. at 64x32, spp 4, depth 8: `render_cuda_diff`'s value bit-identical
      to `render_cuda` with and without work_hint; the hand-written bounce
      adjoint against torch.autograd of the plain bounce on every
      recorded bounce; the kernel's gradient against the plain version's
      per scene field (relative L2 gate), bit-identical run to run and
      for bwd_tile 128 and 256;
   b. at the bench preset, the kernel against the plain version on 16384
      lanes drawn across the image (same gate, times), and the reduction
      against its plain version on the same events;
   c. the main path of the slice: `render_grads_cuda` at the bench preset
      with a zero target, a cold step then warm steps with the work_hint
      carry (seconds, Mrays/s, launch counts, peak memory, finite
      gradients);
   d. the inverse-render demo on the card: exit 0 (albedo error halved);
8. the lane scheduler on the card: at 64x32 and at the bench preset, the
   3-pass compacted render, a work_hint render and a warm cache hit each
   bit-identical to one pixel-order pass; a render of another seed misses
   the cache and runs cold; then render times at the bench preset, cold
   for 1-4 passes and warm for 1-4 passes (best and median of 7 rounds
   that take the settings in turn);
9. the probe path (`probes/kernel_parts.py`, `probes/perf_probe.py`,
   `csrc/probe_kernels.cu`): each of the five probe kernels against its
   plain version at 256 columns and at the scripts' 2048 columns, within
   its gate (`kernel_parts.GATES`); then both probes through their entry
   points (launch counts of all five kernels and render_kernel), and the
   kernels' times at 2048 columns and at 131072 (enough to fill the card)
   with their bounds and the torch.matmul yardsticks.

Then it prints nvidia-smi's line, a JSON line of per-kernel results, and
last `{"ok": true, "device": {...}}`. It imports no JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "ray_tracing_in_one_weekend_tpu_torch"
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(line: str) -> None:
    print(line, flush=True)


def phase_kernel_vs_plain(scene, cam, label):
    """One kernel pass and one plain pass from identical lane state: first a
    budgeted pass (3 iterations) from fresh state, then an unbudgeted pass
    from where it stopped."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import lane_inputs
    from ray_tracing_in_one_weekend_tpu_torch.utils import compare

    spp, depth = cam.samples_per_pixel, cam.max_depth
    p_mat, cam_vec, sf, si, n = lane_inputs(scene, cam)
    table = p_mat.T.contiguous()
    results = []
    for budget in (3, spp * depth):
        args = (cam_vec, (0, 0, 0, budget), sf, si, 128, spp, depth)
        of_k, oi_k = build.render_pass(table, *args)
        of_p, oi_p = cr._render_pass_plain(p_mat, *args)
        torch_sync()
        agree = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
        check(agree.flipped_frac <= 0.02,
              f"{label}: {agree.flipped_frac:.2%} of lanes flipped (budget {budget}), limit 2%")
        check(agree.blocks_agree, f"{label}: block means disagree (budget {budget}): {agree}")
        results.append(agree)
        sf, si = of_p, oi_p
    return results


def torch_sync():
    import torch

    torch.cuda.synchronize()


# Gradient gate: per scene field, ||g_kernel - g_plain|| <= GRAD_GATE * ||g_plain||.
# The replay takes the forward's paths, so only the adjoint's rounding and the
# summation order differ: measured at most 4.7e-5 (H100), gate 2e-4.
GRAD_GATE = 2e-4
# The hand adjoint against autograd of the plain bounce, per output: measured
# at most 2.7e-6, gate 3e-5.
ADJOINT_GATE = 3e-5


def field_errors(scene, pk, pp):
    """Per scene field, the relative L2 error of the kernel's gradient `pk`
    against the plain version's `pp` (both [16, N] packed-scene cotangents),
    and the largest absolute difference over all fields."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    fk, fp = cg.params_vjp(scene, pk), cg.params_vjp(scene, pp)
    rel = {k: rel_l2(fk[k], fp[k]) for k in cg.DIFF_FIELDS}
    return rel, max(float((fk[k] - fp[k]).abs().max()) for k in cg.DIFF_FIELDS)


def phase_adjoint(scene, cam):
    """7a, first part: the hand-written bounce adjoint against
    torch.autograd of the plain `_bounce_f`, on every continuing bounce
    recorded over the image, with random output cotangents."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import adjoint_errors

    m, errs = adjoint_errors(scene, cam)
    for name, e in errs.items():
        check(e <= ADJOINT_GATE,
              f"phase 7a: hand adjoint vs autograd, {name}: rel L2 {e:.2e} > {ADJOINT_GATE}")
    return m, errs


def phase_grad_small(scene, cam):
    """7a: the gradient path at 64x32: the value, the kernel against the
    plain version, and reproducibility across runs and tiles."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent

    img, work = cg.render_cuda_diff(scene, cam, return_work=True)
    check(torch.equal(img, cr.render_cuda(scene, cam)), "phase 7a: value differs from render_cuda")
    check(torch.equal(cg.render_cuda_diff(scene, cam, work_hint=work), img),
          "phase 7a: value with work_hint differs from render_cuda")
    spp, depth, n = cam.samples_per_pixel, cam.max_depth, cam.num_pixels
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    table, work = p_mat.T.contiguous(), work.reshape(-1)
    grad_rad = random_cotangent((3, n), 1, DEVICE)
    scalars = (0, 0, 0, n)
    runs = {}
    for tile in (128, 256, 128):
        pix, g = cg._bwd_lanes(work, grad_rad, spp, tile)
        runs.setdefault(tile, []).append(build.grad_pass(table, cam_vec, scalars, pix, g, work, tile,
                                                         spp, depth))
    pk = runs[128][0]
    check(torch.equal(pk, runs[128][1]), "phase 7a: two kernel runs differ")
    check(torch.equal(pk, runs[256][0]), "phase 7a: bwd_tile 128 and 256 differ")
    pix, g = cg._bwd_lanes(work, grad_rad, spp, 128)
    pp = cg._grad_pass_plain(p_mat, cam_vec, scalars, pix, g, spp, depth)
    errs, _ = field_errors(scene, pk, pp)
    for k, e in errs.items():
        check(e <= GRAD_GATE, f"phase 7a: {k} gradient, kernel vs plain rel L2 {e:.2e} > {GRAD_GATE}")
    return errs


def phase_grad_subset(scene, cam, n_lanes=16384):
    """7b: at the bench preset, the kernel against the plain version on
    `n_lanes` pixels drawn across the whole image (numpy, seed 0); the
    kernel takes pixel ids as data, so the plain version stays affordable
    at full spp and depth. Times both, and the reduction against its plain
    version on the same events."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms, random_cotangent, rel_l2
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    spp, depth, n = cam.samples_per_pixel, cam.max_depth, cam.num_pixels
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    table = p_mat.T.contiguous()
    _, work = cr.render_cuda(scene, cam, return_work=True)
    work = work.reshape(-1)
    pix = np.random.default_rng(0).choice(n, size=n_lanes, replace=False)
    pix = torch.from_numpy(pix.astype(np.int32)).to(DEVICE)
    g = random_cotangent((3, n_lanes), 2, DEVICE) / spp
    args = (table, cam_vec, (0, 0, 0, n), pix, g, work, 128, spp, depth)
    events = build.grad_replay(*args)
    pk = build.grad_reduce(events, p_mat.shape[1])
    replay_ms = cuda_ms(lambda: build.grad_replay(*args), reps=3)
    reduce_ms = cuda_ms(lambda: build.grad_reduce(events, p_mat.shape[1]), reps=3)
    t0 = time.perf_counter()
    pp = cg._grad_pass_plain(p_mat, cam_vec, (0, 0, 0, n), pix, g, spp, depth)
    torch_sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pr = cg._reduce_events_plain(events, p_mat.shape[1])
    torch_sync()
    reduce_plain_ms = (time.perf_counter() - t0) * 1e3
    errs, max_abs = field_errors(scene, pk, pp)
    for k, e in errs.items():
        check(e <= GRAD_GATE, f"phase 7b: {k} gradient, kernel vs plain rel L2 {e:.2e} > {GRAD_GATE}")
    reduce_err = rel_l2(pk, pr)
    reduce_abs_err = float((pk - pr).abs().max())
    check(reduce_err <= 1e-5, f"phase 7b: reduction vs plain rel L2 {reduce_err:.2e} > 1e-5")
    # The library yardstick of the reduction: one index_add_ of the same
    # events' cotangent rows into their spheres' columns.
    idx = events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    keep = idx >= 0
    idx, vals = idx[keep], events[keep, 1:14].T.contiguous()
    acc = torch.zeros(13, p_mat.shape[1], device=DEVICE)
    library_ms = cuda_ms(lambda: acc.index_add_(1, idx, vals), reps=3)
    # Bounds: the replay's sweep (15 operations per sphere test, one sweep
    # per bounce; the adjoint's own operations not counted) against its
    # inputs and the events it writes; the reduction's event reads.
    n_events, n_slots = events.shape[0], p_mat.shape[1]
    replay_bytes = 4.0 * (16 * n_slots + 24 + n_lanes * 4 + work.numel()) + 64.0 * n_events
    replay_bound = kp.bound_ms(float(n_events) * n_slots * kp.OPS_PER_SPHERE_TEST, replay_bytes)
    reduce_bound = kp.bound_ms(13.0 * n_events, 64.0 * n_events + 4.0 * 16 * n_slots)
    return dict(errs=errs, max_abs_err=max_abs, replay_ms=replay_ms, reduce_ms=reduce_ms, plain_ms=plain_ms,
                reduce_plain_ms=reduce_plain_ms, reduce_err=reduce_err,
                reduce_abs_err=reduce_abs_err, n_events=n_events, replay_bound=replay_bound,
                reduce_bound=reduce_bound, reduce_library_ms=library_ms)


def phase_train_step(scene, cam, warm_reps=3):
    """7c: the main path of the gradient slice, `render_grads_cuda` at the
    bench preset with a zero target: a cold step, then warm steps with the
    work_hint carry. Returns times, launch counts and peak memory."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    params = cg.scene_params(scene)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=DEVICE)
    rays = cam.num_pixels * cam.samples_per_pixel
    torch.cuda.reset_peak_memory_stats()
    torch_sync()
    build.reset_launches()
    t0 = time.perf_counter()
    (loss, work), grads = cg.render_grads_cuda(params, scene, cam, target, return_work=True)
    torch_sync()
    cold_s = time.perf_counter() - t0
    warm = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        (loss, work), grads = cg.render_grads_cuda(params, scene, cam, target, return_work=True,
                                                   work_hint=work)
        torch_sync()
        warm.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Full-width bounds of the backward's two kernels, from this step's
    # bounce count: the replay's sweep (one per bounce) against its
    # 64-byte events, and the reduction's event reads.
    n_events, n_slots = float(work.double().sum()), params["center"].shape[0]
    replay_bound = kp.bound_ms(n_events * n_slots * kp.OPS_PER_SPHERE_TEST, 64.0 * n_events)
    reduce_bound = kp.bound_ms(13.0 * n_events, 64.0 * n_events)
    check(bool(torch.isfinite(loss)) and float(loss) > 0.0, "phase 7c: bad loss")
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"phase 7c: non-finite {k} gradient")
    check(sum(float(v.abs().sum()) for v in grads.values()) > 0.0, "phase 7c: all gradients zero")
    for name in ("render_kernel", "grad_kernel", "grad_reduce"):
        check(launches[name] > 0, f"phase 7c: the train step never launched {name}")
    return dict(cold_s=cold_s, warm_s=warm, mrays=[rays / t / 1e6 for t in warm],
                cold_mrays=rays / cold_s / 1e6, launches=launches, peak_gb=peak_gb,
                loss=float(loss), n_events=n_events, replay_bound=replay_bound,
                reduce_bound=reduce_bound)


def phase_scheduler(scene, cam, label):
    """8: compaction, a work_hint and a warm cache hit against one
    pixel-order pass (bit-identical), and a miss on another seed runs the
    cold schedule (DEFAULT_PASSES launches) and refills the entry."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

    cr._WORK_CACHE.clear()
    one, work = cr.render_cuda(scene, cam, n_passes=1, warm=False, return_work=True)
    check(torch.equal(cr.render_cuda(scene, cam, n_passes=3, warm=False), one),
          f"{label}: the 3-pass compacted render differs from one pixel-order pass")
    check(torch.equal(cr.render_cuda(scene, cam, work_hint=work), one),
          f"{label}: the work_hint render differs from one pixel-order pass")
    check(torch.equal(cr.render_cuda(scene, cam), one), f"{label}: the cache-filling render differs")
    check(cr.warm_cache_hit(scene, cam), f"{label}: the cold render did not fill the cache")
    build.reset_launches()
    check(torch.equal(cr.render_cuda(scene, cam), one), f"{label}: the warm cache hit differs")
    check(build.LAUNCHES["render_kernel"] == 1, f"{label}: the warm hit ran {build.LAUNCHES} launches")
    check(not cr.warm_cache_hit(scene, cam, seed=1), f"{label}: seed 1 would hit seed 0's entry")
    build.reset_launches()
    miss = cr.render_cuda(scene, cam, seed=1)
    check(build.LAUNCHES["render_kernel"] == cr.DEFAULT_PASSES,
          f"{label}: the miss ran {build.LAUNCHES['render_kernel']} passes, not the cold schedule")
    check(torch.equal(miss, cr.render_cuda(scene, cam, seed=1, n_passes=1, warm=False)),
          f"{label}: the seed-1 miss differs from one pixel-order pass")
    check(next(iter(cr._WORK_CACHE.values()))[1] == 1, f"{label}: the miss did not refill the entry")


def phase_pass_times(scene, cam, rounds=7):
    """8: render seconds at the bench preset, cold (warm=False) and warm (a
    cache hit) for 1-4 passes: (best, median) of `rounds` rounds, each of
    which times every setting once in turn, after one warm-up of each."""
    import statistics

    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

    settings = {f"{kind} {n}": dict(n_passes=n, warm=kind == "warm")
                for kind in ("cold", "warm") for n in (1, 2, 3, 4)}
    cr._WORK_CACHE.clear()
    cr.render_cuda(scene, cam)  # fills the cache for seed 0: every warm render hits
    for kw in settings.values():
        cr.render_cuda(scene, cam, **kw)
    times = {k: [] for k in settings}
    for _ in range(rounds):
        for k, kw in settings.items():
            torch_sync()
            t0 = time.perf_counter()
            cr.render_cuda(scene, cam, **kw)
            torch_sync()
            times[k].append(time.perf_counter() - t0)
    return {k: (min(ts), statistics.median(ts)) for k, ts in times.items()}


PROBE_REPLACES = {
    "chain_fma": "scripts/perf_probe.py:47",
    "fma_peak": "scripts/kernel_parts_probe.py:67",
    "sweep_probe": "scripts/kernel_parts_probe.py:101",
    "gather_probe": "scripts/kernel_parts_probe.py:148",
    "skinny_probe": "scripts/kernel_parts_probe.py:196",
}


def phase_probes():
    """9: the five probe kernels against their plain versions, then the
    probe path through its entry points with the launch counts set to 0,
    then each kernel's time at the scripts' 2048 columns and at 131072."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.probes import perf_probe as pp

    names = tuple(PROBE_REPLACES)
    dev = torch.device(DEVICE, 0)
    res = {}
    for name in names:
        full = kp.CHAIN if name == "chain_fma" else 64
        for tile, reps in ((256, 64 if name == "chain_fma" else 4), (kp.JAX_TILE, full)):
            args = kp.inputs(name, tile, dev)
            got = kp.run(name, args, reps)
            torch_sync()
            t0 = time.perf_counter()
            want = kp.run_plain(name, args, reps)
            torch_sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = kp.error(name, got, want)
            check(err <= kp.GATES[name],
                  f"phase 9: {name} at {tile} columns, reps {reps}: error {err:.2e} > {kp.GATES[name]}")
            finite = want < 1e29  # a miss of the sweep adds T_MISS = 1e30
            res[name] = dict(err=err, plain_ms=plain_ms, reps=reps,
                             max_abs_err=float((got - want)[finite].abs().max()))
    build.reset_launches()
    parts = kp.main([str(kp.JAX_TILE), "64"])
    probe = pp.main([])
    launches = dict(build.LAUNCHES)
    for name in (*names, "render_kernel"):
        check(launches[name] > 0, f"phase 9: the probe path never launched {name}")
    parts["chain_fma"] = [kp.time_part("chain_fma", t, kp.CHAIN, dev) for t in (kp.JAX_TILE, kp.FILL_TILE)]
    for name in names:
        res[name]["launches"] = launches[name]
        res[name]["timing"], res[name]["fill"] = parts[name]
    return res, probe


def probe_entry(name, v):
    """The `kernels` JSON entry of probe kernel `name` (phase 9 results)."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    t, f = v["timing"], v["fill"]
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/csrc/probe_kernels.cu",
        "replaces": PROBE_REPLACES[name],
        "launches": v["launches"],
        "max_abs_err": v["max_abs_err"],
        "ms": t.ms,
        "plain_ms": v["plain_ms"],
        "bound_ms": t.bound_ms,
        "bound_by": t.bound_by,
        "library_ms": t.library_ms,
        "tolerance": (f"error {v['err']:.3e} against the plain version at {t.tile} columns, reps "
                      f"{v['reps']} (and at 256 columns), gate {kp.GATES[name]:g}: "
                      + ("per lane relative in t with equal miss lanes; max_abs_err over the "
                         "hit lanes" if name == "sweep_probe" else "relative to the largest plain value")),
        "shapes": f"ms, plain_ms, bound_ms at {t.tile} columns, reps {t.reps}; *_fill at {f.tile}",
        "tflops": t.rate / 1e12,
        "ms_fill": f.ms,
        "bound_ms_fill": f.bound_ms,
        "tflops_fill": f.rate / 1e12,
    }
    if t.library_ms is not None:
        entry["library"] = f"{t.reps} x torch.matmul of the same product, float32 (TF32 off)"
        entry["library_ms_fill"] = f.library_ms
    if t.library_tf32_ms is not None:
        entry["library_tf32_ms"] = t.library_tf32_ms
        entry["library_tf32_ms_fill"] = f.library_tf32_ms
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found next to this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import (
        cuda_ms,
        lane_inputs,
        nvidia_smi,
        ptxas_summary,
        small_camera,
    )
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.utils import cli, compare, ppm
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    # 1. card
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 card: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | {kind}")

    # 2. build
    res = build.build()
    build.load()
    say(f"phase 2 build: {res.seconds:.1f}s nvcc into {res.path.relative_to(REPO)} | "
        f"{ptxas_summary(res.log)}")

    # 3. kernel vs plain, one pass
    ref = scene_lib.cover_scene_reference(device=DEVICE)
    a_budget, a_full = phase_kernel_vs_plain(ref, small_camera(DEVICE), "phase 3")
    say(f"phase 3 kernel vs plain (64x32, spp 4, depth 8): flipped lanes "
        f"{a_budget.flipped_frac:.4%} (budget 3), {a_full.flipped_frac:.4%} (to the end); "
        f"block MAD {a_full.block_mad:.2e}, mean diff {a_full.mean_diff:.2e}")

    # 4. sky only, and NaN-as-miss
    cam = small_camera(DEVICE)
    sky = ref.replace(active=torch.zeros_like(ref.active))
    img_k = cr.render_cuda(sky, cam)
    img_p = cr.render_with(cr._render_pass_plain, sky, cam)
    sky_err = float((img_k - img_p).abs().max())
    check(sky_err <= 1e-6, f"phase 4: sky-only image differs from plain by {sky_err}")
    up = small_camera(DEVICE, lookfrom=(0.0, 50.0, 0.0), lookat=(0.0, 100.0, 0.0), vup=(1.0, 0.0, 0.0))
    p_mat = cr.pack_scene(ref)
    check(bool((p_mat[cr._R2][~ref.active] == -1.0).all()), "phase 4: padding slots not at r^2 = -1")
    img, work = cr.render_cuda(ref, up, return_work=True)
    check(bool(torch.isfinite(img).all()), "phase 4: non-finite pixels on sky-bound rays")
    check(bool((work == up.samples_per_pixel).all()),
          "phase 4: a ray aimed away from every sphere hit one (work != spp)")
    check(float((img[..., 2] - 1.0).abs().max()) < 1e-5, "phase 4: sky-bound pixel is not sky blue")
    say(f"phase 4 sky: sky-only max diff {sky_err:.1e}; {img.shape[0] * img.shape[1]} pixels of "
        f"upward rays all sky (one bounce per sample), finite")

    # 5. passes
    one = cr.render_cuda(ref, cam, n_passes=1)
    three = cr.render_cuda(ref, cam, n_passes=3, budget=3)
    check(torch.equal(one, three), "phase 5: n_passes=3, budget=3 differs from one pass")
    say("phase 5 passes: n_passes=3 budget=3 bit-identical to n_passes=1")

    # 6. the main path
    out = REPO / "build" / "smoke.ppm"
    out.parent.mkdir(parents=True, exist_ok=True)
    build.reset_launches()
    run = cli.run(["--preset", "bench", "--backend", "cuda", "--out", str(out)])
    launches = dict(build.LAUNCHES)
    check(launches["render_kernel"] > 0, "phase 6: the CLI never launched render_kernel")
    check(run.backend == "cuda", f"phase 6: CLI ran backend {run.backend}")
    check(run.warm_hit, "phase 6: the CLI's timed render missed the warm-start cache")
    check(out.read_bytes().startswith(b"P3\n1200 800\n255\n"), "phase 6: bad PPM header")
    check(ppm.read_ppm(str(out)).shape == (800, 1200, 3), "phase 6: bad PPM size")
    check(bool(torch.isfinite(run.image).all()), "phase 6: non-finite pixels")

    # The kernel against the plain version at the main path's shapes.
    config = PRESETS["bench"]
    scene = make_scene_from_config(config, DEVICE)
    cam = make_camera_from_config(config, DEVICE)
    spp, depth = cam.samples_per_pixel, cam.max_depth
    p_mat, cam_vec, sf, si, n = lane_inputs(scene, cam)
    table = p_mat.T.contiguous()
    args = (cam_vec, (0, 0, 0, spp * depth), sf, si, 128, spp, depth)
    of_k, oi_k = build.render_pass(table, *args)
    kernel_ms = cuda_ms(lambda: build.render_pass(table, *args), reps=5)
    t0 = time.perf_counter()
    of_p, oi_p = cr._render_pass_plain(p_mat, *args)
    torch_sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    full = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
    # The forward pass's bound: the sweep's operations over this pass's
    # lane-iterations, against its lane state read and written once.
    render_bound = kp.bound_ms(
        float(of_k[cr._SF_WORK].double().sum()) * p_mat.shape[1] * kp.OPS_PER_SPHERE_TEST,
        4.0 * (table.numel() + cam_vec.numel() + 2 * (sf.numel() + si.numel())))
    # Built without FMA contraction, the kernel rounds every operation as the
    # plain version does, so at the main path's shapes the two are identical.
    check(full.blocks_agree, f"phase 6: kernel vs plain at full width: {full}")
    check(full.flipped_frac == 0.0 and full.max_abs_err == 0.0,
          f"phase 6: kernel vs plain at full width not bit-identical: {full}")

    small = cli.run(["--preset", "bench", "--width", "150", "--backend", "cuda", "--no-output"])
    cam150 = make_camera_from_config(small.config, DEVICE)
    plain150 = cr.render_with(cr._render_pass_plain, scene, cam150)
    a150 = compare.images(small.image, plain150, block=10)
    check(a150.blocks_agree, f"phase 6: 150x100 CLI vs plain: {a150}")
    check(a150.flipped_frac == 0.0 and a150.max_abs_err == 0.0,
          f"phase 6: 150x100 CLI vs plain not bit-identical: {a150}")
    mean_gap = abs(float(run.image.mean()) - float(plain150.mean()))
    check(mean_gap < 0.02, f"phase 6: full-width mean is {mean_gap:.4f} off the 150x100 plain mean")
    c = run.config
    say(f"phase 6 main path: bench {c.image_width}x{c.image_height} spp {c.samples_per_pixel} "
        f"depth {c.max_depth} via CLI, {launches['render_kernel']} "
        f"launch(es); render {run.render_s:.4f}s = {run.mrays_per_s:.2f} Mrays/s "
        f"({'warm' if run.warm_hit else 'cold'} schedule; first {run.first_s:.2f}s); "
        f"kernel pass {kernel_ms:.2f} ms (pixel order; bound {render_bound[0]:.3f} ms by "
        f"{render_bound[1]}) vs plain {plain_ms:.0f} ms "
        f"[{smi}]; full-width flipped {full.flipped_frac:.4%}, max lane err "
        f"{full.max_abs_err:.2e}, block MAD {full.block_mad:.2e}; "
        f"150x100 vs plain max pixel err {a150.max_abs_err:.2e}, block MAD {a150.block_mad:.4f}, "
        f"mean diff {a150.mean_diff:.4f}; "
        f"mean gap {mean_gap:.4f}")

    # 7. the gradient path
    cam_small = small_camera(DEVICE)
    m, adj = phase_adjoint(ref, cam_small)
    small_errs = phase_grad_small(ref, cam_small)
    say(f"phase 7a gradient (64x32, spp 4, depth 8): value bit-identical to render_cuda with and "
        f"without work_hint; hand adjoint vs autograd on {m} bounces, rel L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in adj.items())
        + f" (gate {ADJOINT_GATE}); kernel vs plain gradient rel L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in small_errs.items())
        + f" (gate {GRAD_GATE}); bit-identical run to run and for bwd_tile 128 vs 256")
    sub = phase_grad_subset(scene, cam)
    say(f"phase 7b gradient at the bench preset, 16384 lanes: {sub['n_events']} events; kernel vs "
        f"plain rel L2 " + ", ".join(f"{k} {e:.2e}" for k, e in sub["errs"].items())
        + f" (gate {GRAD_GATE}); replay {sub['replay_ms']:.2f} ms + reduce {sub['reduce_ms']:.3f} ms "
        f"vs plain {sub['plain_ms']:.0f} ms; reduce vs plain reduce ({sub['reduce_plain_ms']:.2f} ms) "
        f"rel L2 {sub['reduce_err']:.2e} [{smi}]")
    step = phase_train_step(scene, cam)
    say(f"phase 7c train step (render_grads_cuda, bench preset, zero target): cold "
        f"{step['cold_s']:.4f}s = {step['cold_mrays']:.2f} Mrays/s; warm (work_hint carry) "
        + ", ".join(f"{t:.4f}s" for t in step["warm_s"]) + " = "
        + ", ".join(f"{r:.2f}" for r in step["mrays"]) + f" Mrays/s; launches {step['launches']}; "
        f"peak memory {step['peak_gb']:.2f} GB; gradients finite on every field; full-width bounds "
        f"({step['n_events']:.0f} bounces): replay {step['replay_bound'][0]:.3f} ms by "
        f"{step['replay_bound'][1]}, reduction {step['reduce_bound'][0]:.3f} ms by "
        f"{step['reduce_bound'][1]} [{smi}]")
    from ray_tracing_in_one_weekend_tpu_torch.examples import inverse_render

    demo_dir = REPO / "build" / "inverse_render"
    rc = inverse_render.main(["--device", DEVICE, "--outdir", str(demo_dir)])
    check(rc == 0, f"phase 7d: the inverse-render demo exited {rc}")
    check((demo_dir / "inverse_recovered.ppm").read_bytes().startswith(b"P3\n64 32\n255\n"),
          "phase 7d: bad recovered PPM")
    say("phase 7d inverse render: the demo recovered sphere 1's albedo (error at least halved)")

    # 8. the lane scheduler
    phase_scheduler(ref, cam_small, "phase 8 (64x32)")
    phase_scheduler(scene, cam, "phase 8 (bench)")
    times = phase_pass_times(scene, cam)
    say("phase 8 scheduler: at 64x32 and at the bench preset the 3-pass compacted, work_hint and "
        "warm-hit renders are bit-identical to one pixel-order pass; a seed-1 miss ran the cold "
        f"{cr.DEFAULT_PASSES}-pass schedule and refilled the cache. Bench render s (best, median of "
        "7 interleaved rounds): " + "; ".join(f"{k} passes {b:.5f}, {m:.5f}" for k, (b, m) in times.items())
        + f" [{smi}]")

    # 9. the probe path
    probes, probe = phase_probes()
    say("phase 9 probes: kernel vs plain (error, gate) " + ", ".join(
        f"{k} {v['err']:.2e} ({kp.GATES[k]:g})" for k, v in probes.items()))
    for k, v in probes.items():
        say(f"phase 9 {k}: launches {v['launches']}; {v['timing'].line()}; {v['fill'].line()}; "
            f"plain {v['plain_ms']:.2f} ms at {kp.JAX_TILE} columns [{smi}]")
    say(f"phase 9 perf_probe: warp occupancy cold {probe['occupancy_cold']:.4f}, pixel order "
        f"{probe['occupancy_pixel']:.4f}, warm {probe['occupancy_warm']:.4f}; render s cold "
        f"{probe['render_s']:.5f}, pixel order {probe['render_s_pixel']:.5f}, warm "
        f"{probe['render_s_warm']:.5f}; sweep roofline {probe['roofline_s'] * 1e3:.3f} ms = "
        f"{probe['roofline_share_cold']:.3f} of cold, {probe['roofline_share_warm']:.3f} of warm; "
        f"fma peak {probe['peak_tflops']:.2f} TFLOP/s, chain {probe['chain_tflops']:.2f} TFLOP/s [{smi}]")

    check("jax" not in sys.modules and "flax" not in sys.modules, "JAX was imported")
    say(smi)
    grad_tol = (f"max_abs_err: largest |g_kernel - g_plain| of any scene-field gradient at the "
                f"bench preset, 16384 lanes; gates: per field rel L2 <= {GRAD_GATE} there and at "
                f"64x32 spp 4, bit-identical run to run and across bwd_tile 128/256, hand adjoint "
                f"vs autograd rel L2 <= {ADJOINT_GATE}")
    say(json.dumps({"kernels": [{
        "name": "render_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/render_kernel.cu",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_render.py:477",
        "launches": launches["render_kernel"],
        "max_abs_err": full.max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "tolerance": "max_abs_err: largest per-lane radiance difference of one bench pass; "
                     "gates: bit-identical lane state at full width (0 flipped lanes, "
                     "max_abs_err 0) and a bit-identical 150x100 CLI image; at 64x32 spp 4, "
                     "flipped lanes (|d| > 1e-4 or an integer row differs) <= 2% and 256-lane "
                     "block means MAD < 0.02, mean diff < 0.01",
        "bound_ms": render_bound[0],
        "bound_by": render_bound[1],
        "library_ms": None,
        "flipped_frac": full.flipped_frac,
        "block_mad": full.block_mad,
        "render_s": run.render_s,
        "render_warm_hit": run.warm_hit,
        "mrays_per_s": run.mrays_per_s,
        "pass_times_s": times,
    }, {
        "name": "grad_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/grad_kernel.cu",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py:151",
        "launches": step["launches"]["grad_kernel"],
        "max_abs_err": sub["max_abs_err"],
        "ms": sub["replay_ms"],
        "plain_ms": sub["plain_ms"],
        "tolerance": grad_tol,
        "bound_ms": sub["replay_bound"][0],
        "bound_by": sub["replay_bound"][1],
        "library_ms": None,
        "shapes": "bench preset, 16384 lanes drawn across the image (ms, plain_ms and bound_ms alike)",
        "rel_l2": sub["errs"],
        "rel_l2_64x32": small_errs,
        "adjoint_rel_l2": adj,
        "step_cold_s": step["cold_s"],
        "step_warm_s": step["warm_s"],
        "step_mrays_per_s": step["mrays"],
        "peak_memory_gb": step["peak_gb"],
        "bound_ms_full_width": step["replay_bound"][0],
    }, {
        "name": "grad_reduce",
        "route": "cuda",
        "source": f"{PKG}/csrc/grad_kernel.cu",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py:476",
        "launches": step["launches"]["grad_reduce"],
        "max_abs_err": sub["reduce_abs_err"],
        "ms": sub["reduce_ms"],
        "plain_ms": sub["reduce_plain_ms"],
        "tolerance": "rel L2 <= 1e-5 against index_add over the same events (summation order)",
        "bound_ms": sub["reduce_bound"][0],
        "bound_by": sub["reduce_bound"][1],
        "library_ms": sub["reduce_library_ms"],
        "library": "one index_add_ of the events' 13 cotangent rows into [13, N]",
        "bound_ms_full_width": step["reduce_bound"][0],
        "rel_l2": sub["reduce_err"],
    }, *(probe_entry(name, v) for name, v in probes.items())]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
