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
2. build: nvcc, timed, with ptxas' register report; then for each of
   the three kernels that sweep the scene (render, replay, sweep probe)
   its registers and spills, its resident blocks an SM at a tile of 128
   (the CUDA runtime's occupancy, beside the occupancy rules'), and the
   SASS instructions its sweep loop issues per sphere test
   (`probes/sweep_readings.py`; "not available" without cuobjdump);
3. kernel vs plain, one pass from identical lane state (64x32, spp 4,
   depth 8, tile 128, the reference cover scene): at most 2% flipped
   lanes, 256-lane block-mean MAD < 0.02 and mean difference < 0.01;
4. sky only (every sphere inactive) equal to the plain version to 1e-6,
   and NaN-as-miss: rays aimed away from every sphere all see the sky;
   a scene of exact ties (`probes.tie_scene`, 11 slots: ties inside the
   sweep's first group of 8 and in its remainder) and the same scene cut
   to 9, 5 and 3 slots bit-identical to the plain version, each equal to
   the scene without its duplicates (the lowest index wins every tie);
5. n_passes=3, budget=3 bit-identical to one pass;
6. the main path: the CLI at full width through the kernel (launch count
   > 0, P3 header, finite pixels, render seconds and Mrays/s; the timed
   render is the warm one, a hit of the schedule cache); the kernel
   against the plain version at the main path's shapes (times; the lane
   states must be bit-identical, as the build without FMA contraction
   makes them); and the 150x100 CLI render against the plain version
   (bit-identical, and block means as in phase 3);
7. the gradient path (`ops/cuda_grad.py`, `csrc/grad_kernel.cu`: the
   replay kernel, the reverse kernel and the reduction):
   a. at 64x32, spp 4, depth 8: `render_cuda_diff`'s value bit-identical
      to `render_cuda` with and without work_hint; the hand-written bounce
      adjoint against torch.autograd of the plain bounce on every
      recorded bounce; the replay kernel's records bit-identical to the
      plain replay's (all 16 words); the reverse kernel's events against
      the plain reverse on the same records (winners equal, cotangents
      within EVENT_GATE, the error also read by distance from the path's
      end); the gradient against the plain backward's
      per scene field (relative L2 gate), bit-identical run to run and for
      bwd_tile 128 and 256;
   b. at the bench preset, the same checks on 16384 lanes drawn across
      the image and sorted by cost as the main path sorts (the plain
      versions' times), and the reduction against its plain version on
      the same events;
   c. the main path of the slice: `render_grads_cuda` at the bench preset
      with a zero target, a cold step then warm steps with the work_hint
      carry (seconds, Mrays/s, launch counts, peak memory, finite
      gradients); then the replay, the reverse, the reduction and its
      `index_add_` yardstick timed at full width on the step's own lanes;
   d. the inverse-render demo on the card: exit 0 (albedo error halved);
8. the lane scheduler on the card: at 64x32 and at the bench preset, the
   3-pass compacted render, a work_hint render and a warm cache hit each
   bit-identical to one pixel-order pass; a render of another seed misses
   the cache and runs cold; then render times at the bench preset, cold
   for 1-4 passes and warm for 1-4 passes (best and median of 7 rounds
   that take the settings in turn);
9. the probe path (`probes/kernel_parts.py`, `probes/perf_probe.py`,
   `csrc/probe_kernels.cu`): each of the six probe kernels against its
   plain version at 256 columns, at the scripts' 2048 columns and at the
   131072 the probe path also times, within its gate
   (`kernel_parts.GATES`; the sweep probe bit for bit); then both probes
   through their entry points (launch counts of all six kernels and
   render_kernel), and the kernels' times at 2048 columns and at 131072
   (enough to fill the card) with their bounds (tensor-core work
   included) and the torch.matmul yardsticks.

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
# The reverse kernel's events against the plain reverse's on the same records
# (cotangent words, relative L2). An event carries the chain of adjoints from
# its path's end back to its bounce, and its error grows with that distance
# (check_split reads it so; H100): about 1e-7 one or two bounces from the
# end, 1e-5 to 6e-5 four to seven bounces back, 1.3e-4 eight or more, and
# 3.1e-5 / 6.2e-5 over all events at 64x32 / on 16384 bench lanes. Gate 2e-4.
EVENT_GATE = 2e-4

def field_errors(scene, pk, pp):
    """Per scene field, the relative L2 error of the kernel's gradient `pk`
    against the plain version's `pp` (both [16, N] packed-scene cotangents)."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    fk, fp = cg.params_vjp(scene, pk), cg.params_vjp(scene, pp)
    return {k: rel_l2(fk[k], fp[k]) for k in cg.DIFF_FIELDS}


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


def check_split(p_mat, cam_vec, scalars, pix, g, work, spp, depth, label):
    """The backward's two kernels against their plain versions on the same
    lanes: the replay's records bit-identical to `_replay_records_plain`
    (all 16 words, the same slots), the reverse's events against
    `_reverse_records_plain` on the same records (winners equal, cotangent
    words within EVENT_GATE relative L2). Returns the events and the
    errors, the events' error by distance from their path's end (1 to 7,
    then 8 and more), and the plain versions' ms."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    table = p_mat.T.contiguous()
    replay = build.grad_replay(table, cam_vec, scalars, pix, work, 128, spp, depth)
    out = {}
    torch_sync()
    t0 = time.perf_counter()
    plain = cg._replay_records_plain(p_mat, cam_vec, scalars, pix, spp, depth)
    torch_sync()
    out["replay_plain_ms"] = (time.perf_counter() - t0) * 1e3
    check(torch.equal(replay.ev_start, plain.ev_start) and torch.equal(replay.ev_count, plain.ev_count),
          f"{label}: the replay kernel's record slots differ from the plain replay's")
    out["record_abs_err"] = float((replay.records[:, :9] - plain.records[:, :9]).abs().max())
    same = replay.records.view(torch.int32) == plain.records.view(torch.int32)
    check(bool(same.all()), f"{label}: {int((~same.all(1)).sum())} of {same.shape[0]} records differ from "
                            "the plain replay's (bit-identical required)")
    t0 = time.perf_counter()
    want = cg._reverse_records_plain(p_mat, cam_vec, plain, g)
    torch_sync()
    out["reverse_plain_ms"] = (time.perf_counter() - t0) * 1e3
    events = build.grad_reverse(table, cam_vec, replay, g, 128)
    wk, wp = events[:, 0].view(torch.int32), want[:, 0].view(torch.int32)
    check(torch.equal(wk, wp), f"{label}: {int((wk != wp).sum())} event winners differ from the plain reverse's")
    out["event_err"] = rel_l2(events[:, 1:14], want[:, 1:14])
    out["event_abs_err"] = float((events[:, 1:14] - want[:, 1:14]).abs().max())
    check(out["event_err"] <= EVENT_GATE,
          f"{label}: reverse kernel vs plain events rel L2 {out['event_err']:.2e} > {EVENT_GATE}")
    back = cg._path_positions(plain.records)[2].clamp(max=8)
    out["event_err_by_back"] = {}
    for b in range(1, 9):
        sel = ((back == b) & (wk >= 0)).nonzero()[:, 0]
        if sel.numel():
            out["event_err_by_back"]["8+" if b == 8 else str(b)] = rel_l2(events[sel, 1:14], want[sel, 1:14])
    out["n_events"] = events.shape[0]
    return events, out


def reverse_ms(table, cam_vec, replay, g, tile, reps=3):
    """(mean ms of `grad_reverse` on `replay`'s records by CUDA events
    around each launch alone, the events). Each launch gets a fresh copy
    of the records, which keeps the card busy while the host queues the
    launch; `replay` itself stays unreversed."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    buf = torch.empty_like(replay.records)
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        buf.copy_(replay.records)
        start.record()
        build.grad_reverse(table, cam_vec, build.Replay(buf, replay.ev_start, replay.ev_count), g, tile)
        end.record()
    torch_sync()
    return sum(start.elapsed_time(end) for start, end in marks) / reps, buf


def backward_bounds(n_events, n_slots, n_lanes):
    """The least times of the backward's three kernels for this run's
    bounces: the replay's sweep (15 operations per sphere test, one sweep
    per bounce) against its inputs and 64-byte records; the reverse's
    record reads and event writes (its operations are not counted: it runs
    no sweep, and the bytes bound it, see PERF.md); the reduction's event
    reads."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    table = 4.0 * (16 * n_slots + 24)
    replay = kp.bound_ms(float(n_events) * n_slots * kp.OPS_PER_SPHERE_TEST,
                         table + 16.0 * n_lanes + 64.0 * n_events)  # pix, ev_start, ev_count per lane
    reverse = kp.bound_ms(0.0, table + 24.0 * n_lanes + 128.0 * n_events)  # g, ev_start, ev_count per lane
    reduce = kp.bound_ms(13.0 * n_events, 64.0 * n_events + 4.0 * 16 * n_slots)
    return replay, reverse, reduce


def phase_grad_small(scene, cam):
    """7a: the gradient path at 64x32: the value, each backward kernel
    against its plain version, the gradient against the plain backward,
    and reproducibility across runs and tiles."""
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
    _, split = check_split(p_mat, cam_vec, scalars, pix, g, work, spp, depth, "phase 7a")
    pp = cg._grad_pass_plain(p_mat, cam_vec, scalars, pix, g, spp, depth)
    errs = field_errors(scene, pk, pp)
    for k, e in errs.items():
        check(e <= GRAD_GATE, f"phase 7a: {k} gradient, kernel vs plain rel L2 {e:.2e} > {GRAD_GATE}")
    return errs, split


def phase_grad_subset(scene, cam, n_lanes=16384):
    """7b: at the bench preset, on `n_lanes` pixels drawn across the whole
    image (numpy, seed 0) and sorted by cost as the main path sorts its
    lanes: each backward kernel against its plain version, the reduction
    against its plain version on the same events, and the gradient against
    the plain backward. The kernels take pixel ids as
    data, so the plain versions stay affordable at full spp and depth."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent, rel_l2

    spp, depth, n = cam.samples_per_pixel, cam.max_depth, cam.num_pixels
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    _, work = cr.render_cuda(scene, cam, return_work=True)
    work = work.reshape(-1)
    pix = torch.from_numpy(np.random.default_rng(0).choice(n, size=n_lanes, replace=False)).to(DEVICE)
    pix = pix[cr._cost_perm(work[pix])].to(torch.int32)
    g = random_cotangent((3, n_lanes), 2, DEVICE) / spp
    events, out = check_split(p_mat, cam_vec, (0, 0, 0, n), pix, g, work, spp, depth, "phase 7b")
    pk = build.grad_reduce(events, p_mat.shape[1])
    reduce_ms, library_ms = reduce_times(events, p_mat.shape[1])
    t0 = time.perf_counter()
    pp = cg._grad_pass_plain(p_mat, cam_vec, (0, 0, 0, n), pix, g, spp, depth)
    torch_sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pr = cg._reduce_events_plain(events, p_mat.shape[1])
    torch_sync()
    reduce_plain_ms = (time.perf_counter() - t0) * 1e3
    errs = field_errors(scene, pk, pp)
    for k, e in errs.items():
        check(e <= GRAD_GATE, f"phase 7b: {k} gradient, kernel vs plain rel L2 {e:.2e} > {GRAD_GATE}")
    reduce_err = rel_l2(pk, pr)
    reduce_abs_err = float((pk - pr).abs().max())
    check(reduce_err <= 1e-5, f"phase 7b: reduction vs plain rel L2 {reduce_err:.2e} > 1e-5")
    reduce_bound = backward_bounds(out["n_events"], p_mat.shape[1], n_lanes)[2]
    return dict(out, errs=errs, reduce_ms=reduce_ms, plain_ms=plain_ms, reduce_plain_ms=reduce_plain_ms,
                reduce_err=reduce_err, reduce_abs_err=reduce_abs_err, reduce_bound=reduce_bound,
                reduce_library_ms=library_ms)


def reduce_times(events, n_slots):
    """(ms of `grad_reduce` on `events`, ms of its library yardstick): one
    index_add_ of the same events' 13 cotangent rows into their spheres'
    columns."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms

    idx = events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    keep = idx >= 0
    idx, vals = idx[keep], events[keep, 1:14].T.contiguous()
    acc = torch.zeros(13, n_slots, device=events.device)
    return (cuda_ms(lambda: build.grad_reduce(events, n_slots), reps=3),
            cuda_ms(lambda: acc.index_add_(1, idx, vals), reps=3))


def phase_train_step(scene, cam, warm_reps=3):
    """7c: the main path of the gradient slice, `render_grads_cuda` at the
    bench preset with a zero target: a cold step, then warm steps with the
    work_hint carry. Returns times, launch counts and peak memory; then
    times each backward kernel at full width on the step's own lanes."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

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
    # The cold schedule once more, now that the allocator holds the step's blocks.
    t0 = time.perf_counter()
    cg.render_grads_cuda(params, scene, cam, target)
    torch_sync()
    cold_again_s = time.perf_counter() - t0
    check(bool(torch.isfinite(loss)) and float(loss) > 0.0, "phase 7c: bad loss")
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"phase 7c: non-finite {k} gradient")
    check(sum(float(v.abs().sum()) for v in grads.values()) > 0.0, "phase 7c: all gradients zero")
    for name in ("render_kernel", "grad_replay", "grad_reverse", "grad_reduce"):
        check(launches[name] > 0, f"phase 7c: the train step never launched {name}")
    # Each backward kernel at full width on the step's paths (seed 0, this
    # step's work map, its cost-sorted lanes; a random radiance cotangent:
    # the record slots and spheres do not depend on it), and index_add_.
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import profiled_ms, random_cotangent

    n, w, tile = cam.num_pixels, work.reshape(-1), cg.DEFAULT_BWD_TILE
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    table = p_mat.T.contiguous()
    pix, g = cg._bwd_lanes(w, random_cotangent((3, n), 3, DEVICE), cam.samples_per_pixel, tile)
    args = (table, cam_vec, (0, 0, 0, n), pix, w, tile, cam.samples_per_pixel, cam.max_depth)
    replay = build.grad_replay(*args)
    # The replay's wrapper sums the slots and syncs, so its kernel is timed by
    # the profiler's device time rather than by events around the call.
    replay_ms = profiled_ms(lambda: build.grad_replay(*args), "grad_replay_kernel", reps=3)
    reverse, events = reverse_ms(table, cam_vec, replay, g, tile)
    n_events = events.shape[0]
    check(n_events == int(w.double().sum()), "phase 7c: the replay's records differ from the step's bounces")
    reduce_ms, library_ms = reduce_times(events, p_mat.shape[1])
    bounds = backward_bounds(n_events, p_mat.shape[1], pix.numel())
    return dict(cold_s=cold_s, warm_s=warm, mrays=[rays / t / 1e6 for t in warm],
                cold_mrays=rays / cold_s / 1e6, launches=launches, peak_gb=peak_gb,
                loss=float(loss), n_events=n_events, replay_ms=replay_ms, cold_again_s=cold_again_s,
                reverse_ms=reverse, replay_bound=bounds[0], reverse_bound=bounds[1],
                reduce_bound=bounds[2], reduce_ms=reduce_ms, reduce_library_ms=library_ms)


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
    "skinny_probe_default": "scripts/kernel_parts_probe.py:196",
}


def phase_probes():
    """9: the six probe kernels against their plain versions at 256, 2048
    and 131072 columns, then the probe path through its entry points with
    the launch counts set to 0, which times each kernel at the scripts'
    2048 columns and at 131072."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.probes import perf_probe as pp

    names = tuple(PROBE_REPLACES)
    dev = torch.device(DEVICE, 0)
    res = {}
    for name in names:
        full = kp.CHAIN if name == "chain_fma" else 64
        res[name] = dict(err=0.0, max_abs_err=0.0)
        # 256 columns at few reps, then the shapes the probe path times.
        for tile, reps in ((256, 64 if name == "chain_fma" else 4), (kp.JAX_TILE, full), (kp.FILL_TILE, full)):
            args = kp.inputs(name, tile, dev)
            got = kp.run(name, args, reps)
            torch_sync()
            t0 = time.perf_counter()
            want = kp.run_plain(name, args, reps)
            torch_sync()
            if tile == kp.JAX_TILE:
                res[name]["plain_ms"] = (time.perf_counter() - t0) * 1e3
            err = kp.error(name, got, want)
            check(err <= kp.GATES[name],
                  f"phase 9: {name} at {tile} columns, reps {reps}: error {err:.2e} > {kp.GATES[name]}")
            # The sweep probe runs the render's closest_hit, built without
            # contraction: the plain version's bits.
            check(name != "sweep_probe" or torch.equal(got, want),
                  f"phase 9: sweep_probe at {tile} columns differs from its plain version")
            finite = want < 1e29  # a miss of the sweep adds T_MISS = 1e30
            res[name]["err"] = max(res[name]["err"], err)
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], float((got - want)[finite].abs().max()))
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


def probe_entry(name, v, reading=None):
    """The `kernels` JSON entry of probe kernel `name` (phase 9 results,
    and the sweep readings of phase 2 for the sweep probe)."""
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
        # Tensor-core operations count as operations here; phase 9's lines
        # name the term.
        "bound_by": "bytes" if t.bound_by == "bytes" else "operations",
        "library_ms": t.library_ms,
        "tolerance": (f"largest error {v['err']:.3e} against the plain version at 256, {t.tile} and "
                      f"{f.tile} columns, gate {kp.GATES[name]:g}: "
                      + ("per lane relative in t with equal miss lanes; max_abs_err over the "
                         "hit lanes" if name == "sweep_probe" else "relative to the largest plain value")),
        "shapes": f"ms, plain_ms, bound_ms at {t.tile} columns, reps {t.reps}; *_fill at {f.tile}",
        "tflops": t.rate / 1e12,
        "ms_fill": f.ms,
        "bound_ms_fill": f.bound_ms,
        "tflops_fill": f.rate / 1e12,
    }
    if t.library_ms is not None:
        entry["library"] = f"{t.reps} x torch.matmul of the same product, " + (
            "bf16 in" if name == "skinny_probe_default" else "float32 (TF32 off)")
        entry["library_ms_fill"] = f.library_ms
    if t.library_tf32_ms is not None:
        entry["library_tf32_ms"] = t.library_tf32_ms
        entry["library_tf32_ms_fill"] = f.library_tf32_ms
    if reading is not None:
        entry.update(reading.fields())
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
        first_slots,
        lane_inputs,
        nvidia_smi,
        ptxas_summary,
        small_camera,
        tie_camera,
        tie_scene,
        without_duplicates,
    )
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings
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
    readings = {r.kernel: r for r in sweep_readings.readings(
        res.log, res.path, sweep_readings.TABLE_BYTES,
        lambda k: build.blocks_per_sm(k, sweep_readings.TILE, sweep_readings.N_SLOTS))}
    for r in readings.values():
        say(f"phase 2 {r.line()}")

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
    ties, tcam = tie_scene(DEVICE), tie_camera(DEVICE)
    for n_slots in (11, 9, 5, 3):
        cut = first_slots(ties, n_slots)
        img_k = cr.render_cuda(cut, tcam)
        check(torch.equal(img_k, cr.render_with(cr._render_pass_plain, cut, tcam)),
              f"phase 4: the {n_slots}-slot tie scene differs from the plain version")
        check(torch.equal(img_k, cr.render_cuda(without_duplicates(cut), tcam)),
              f"phase 4: a tie of the {n_slots}-slot scene went to the higher sphere index")
    say(f"phase 4 sky: sky-only max diff {sky_err:.1e}; {img.shape[0] * img.shape[1]} pixels of "
        f"upward rays all sky (one bounce per sample), finite; the tie scene at 11, 9, 5 and 3 slots "
        f"bit-identical to the plain version, the lowest index winning every tie")

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
    small_errs, small = phase_grad_small(ref, cam_small)

    def by_back(split):
        return ", ".join(f"{b} {e:.2e}" for b, e in split["event_err_by_back"].items())

    say(f"phase 7a gradient (64x32, spp 4, depth 8): value bit-identical to render_cuda with and "
        f"without work_hint; hand adjoint vs autograd on {m} bounces, rel L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in adj.items())
        + f" (gate {ADJOINT_GATE}); {small['n_events']} replay records bit-identical to the plain "
        f"replay's; reverse events vs plain: winners equal, rel L2 {small['event_err']:.2e} (gate "
        f"{EVENT_GATE}; by bounces from the path's end: {by_back(small)}); gradient vs plain rel L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in small_errs.items())
        + f" (gate {GRAD_GATE}); bit-identical run to run and for bwd_tile 128 vs 256")
    sub = phase_grad_subset(scene, cam)
    say(f"phase 7b gradient at the bench preset, 16384 cost-sorted lanes: {sub['n_events']} records "
        f"bit-identical to the plain replay's; reverse events vs plain: winners equal, rel L2 "
        f"{sub['event_err']:.2e} (gate {EVENT_GATE}; by bounces from the path's end: {by_back(sub)}); "
        f"gradient vs plain rel L2 " + ", ".join(f"{k} {e:.2e}" for k, e in sub["errs"].items())
        + f" (gate {GRAD_GATE}); plain replay {sub['replay_plain_ms']:.0f} ms, plain reverse "
        f"{sub['reverse_plain_ms']:.0f} ms, whole plain backward {sub['plain_ms']:.0f} ms; reduce "
        f"{sub['reduce_ms']:.3f} ms vs plain reduce ({sub['reduce_plain_ms']:.2f} ms) rel L2 "
        f"{sub['reduce_err']:.2e} [{smi}]")
    step = phase_train_step(scene, cam)
    say(f"phase 7c train step (render_grads_cuda, bench preset, zero target): cold "
        f"{step['cold_s']:.4f}s = {step['cold_mrays']:.2f} Mrays/s (again after the warm steps: "
        f"{step['cold_again_s']:.4f}s); warm (work_hint carry) "
        + ", ".join(f"{t:.4f}s" for t in step["warm_s"]) + " = "
        + ", ".join(f"{r:.2f}" for r in step["mrays"]) + f" Mrays/s; launches {step['launches']}; "
        f"peak memory {step['peak_gb']:.3f} GB; gradients finite on every field; at full width on the "
        f"step's lanes ({step['n_events']} bounces): replay {step['replay_ms']:.3f} ms (bound "
        f"{step['replay_bound'][0]:.3f} by {step['replay_bound'][1]}), reverse {step['reverse_ms']:.3f} ms "
        f"(bound {step['reverse_bound'][0]:.3f} by {step['reverse_bound'][1]}), reduction "
        f"{step['reduce_ms']:.3f} ms (bound {step['reduce_bound'][0]:.3f} by {step['reduce_bound'][1]}), "
        f"index_add_ {step['reduce_library_ms']:.3f} ms [{smi}]")
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
    grad_tol = (f"the gradient after the reduction: per field rel L2 <= {GRAD_GATE} against the plain "
                f"backward on 16384 lanes and at 64x32 spp 4, bit-identical run to run and across "
                f"bwd_tile 128/256; hand adjoint vs autograd rel L2 <= {ADJOINT_GATE}")
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
        **readings["render_kernel"].fields(),
        "render_s": run.render_s,
        "render_warm_hit": run.warm_hit,
        "mrays_per_s": run.mrays_per_s,
        "pass_times_s": times,
    }, {
        "name": "grad_replay_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/grad_kernel.cu",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py:151 (Phase A, :231-330)",
        "launches": step["launches"]["grad_replay"],
        "max_abs_err": sub["record_abs_err"],
        "ms": step["replay_ms"],
        "plain_ms": sub["replay_plain_ms"],
        "tolerance": "records bit-identical to the plain replay (all 16 words, the same slots) at 64x32 "
                     "and on 16384 cost-sorted bench lanes; " + grad_tol,
        "bound_ms": step["replay_bound"][0],
        "bound_by": step["replay_bound"][1],
        "library_ms": None,
        "shapes": "ms (the kernel's device time by torch.profiler) and bound_ms at full width on the "
                  "train step's own cost-sorted lanes; plain_ms on 16384 cost-sorted bench lanes",
        **readings["grad_replay"].fields(),
        "rel_l2": sub["errs"],
        "rel_l2_64x32": small_errs,
        "adjoint_rel_l2": adj,
        "step_cold_s": step["cold_s"],
        "step_warm_s": step["warm_s"],
        "step_mrays_per_s": step["mrays"],
        "peak_memory_gb": step["peak_gb"],
    }, {
        "name": "grad_reverse_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/grad_kernel.cu (+ grad_device.cuh)",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py:151 (Phase B, :332-498)",
        "launches": step["launches"]["grad_reverse"],
        "max_abs_err": sub["event_abs_err"],
        "ms": step["reverse_ms"],
        "plain_ms": sub["reverse_plain_ms"],
        "tolerance": f"events against the plain reverse on the same records: winners equal, cotangent "
                     f"words rel L2 <= {EVENT_GATE}; max_abs_err on the 16384 lanes",
        "bound_ms": step["reverse_bound"][0],
        "bound_by": step["reverse_bound"][1],
        "library_ms": None,
        "shapes": "ms and bound_ms at full width on the train step's own lanes, each launch on a fresh "
                  "copy of the records; plain_ms on 16384 cost-sorted bench lanes",
        "rel_l2": sub["event_err"],
        "rel_l2_64x32": small["event_err"],
        "rel_l2_by_back": sub["event_err_by_back"],
        "rel_l2_by_back_64x32": small["event_err_by_back"],
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
        "ms_full_width": step["reduce_ms"],
        "library_ms_full_width": step["reduce_library_ms"],
        "rel_l2": sub["reduce_err"],
    }, *(probe_entry(name, v, readings.get(name)) for name, v in probes.items())]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
