"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Run from the root of a checkout. It builds the hand-written kernels from
`ray_tracing_in_one_weekend_tpu_torch/csrc/` with nvcc (into the ignored
`build/kernels/`), checks each against its plain PyTorch version on the
card, and drives the port's paths through the kernels: at the bench
preset (the cover scene, 1200x800, 10 spp, depth 50) the render CLI with
its lane scheduler, the fwd+bwd train step of inverse rendering, and the
occupancy and roofline probes; at the gpu and cpu-mt presets (500 spp)
the long render, checkpointed, resumed and retried; in local ranks at
the bench preset, the sharded render, train step, CLI and dry run; and
the book's milestone scenes and cameras at the book's size, the
closed-form render probes and the milestone shading renders; the four
reference presets at 500 spp, held to the reference's image and to the
TPU's renders, and the scheduling sweep; and, with no kernel, the
differentiable render under torch.autograd, held to the kernels; and the
jnp backend on threefry keys, its forward kernel and its gradient (the
keyed recording forward and reverse kernels), held to torch.autograd on
the card.

Phases, one line each; any failure raises and the script exits non-zero
without the result lines:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: nvcc, timed, with ptxas' register report (and the reduction's
   chunk kernel's blocks an SM); then for each of
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
      bwd_tile 128 and 256; the reduction kernel bit-identical to its
      ordered plain version (`_reduce_events_ordered`) on the events;
   b. at the bench preset, the same checks on 16384 lanes drawn across
      the image and sorted by cost as the main path sorts (the plain
      versions' times), and the reduction bit-identical to its ordered
      plain version and against index_add on the same events;
   c. the main path of the slice: `render_grads_cuda` at the bench preset
      with a zero target, a cold step then warm steps with the work_hint
      carry (seconds, Mrays/s, launch counts, peak memory, finite
      gradients); then the replay, the reverse, the reduction and its
      `index_add_` yardstick timed at full width on the step's own lanes;
      the reduction there bit-identical to its ordered plain version, its
      two kernels timed apart (torch.profiler) and, with `--parent DIR`
      (another checkout of the port, built by its own `kernels/build.py`),
      the parent's pair on the same events in turns, with the events'
      share of no sphere and the heaviest sphere's events a chunk;
   d. the inverse-render demo on the card (`--backend pallas`): exit 0
      (albedo error halved);
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
   included) and the torch.matmul yardsticks; and chain_fma_kernel at
   CHAIN_REMAINDER steps (its unrolled loop's remainder) within its gate,
   its registers and the FFMA share of its main loop's SASS (at least
   CHAIN_FFMA_SHARE; "not available" without cuobjdump), and the sha256
   of its 2048-column, 512-step output (with `--parent`, which must be the
   parent checkout's);
10. the long render (`utils/checkpoint.py`, `utils/resilient.py`, the
   CLI's batched path):
   a. at 150x100, spp 64, batches of 10: the accumulation through the
      kernel bit-identical to the same accumulation through the plain
      version, one or more render_kernel launches a batch;
   b. the main path of the slice at the gpu preset (1920x1080, 500 spp):
      the CLI with `--checkpoint` to 250 spp, then resumed to 500 (launch
      counts from 0); the image within LONG_RENDER_GATE of the exact mean
      of its 500 samples, each rendered alone by sample_offset, whose
      float32 sum must be one 500-spp render's bits; no 8-bit value more
      than one level off that render;
   c. one NaN batch and one raised batch injected under
      `render_resilient`: the recovered image bit-identical to 10a's;
   d. the CLI's batched path at the gpu and cpu-mt presets (3840x2160):
      seconds a batch, steady Mrays/s, peak memory, and the warm-cache
      fill's share of a batch;
   e. the kernel against the plain version at the shapes of the last
      batch of those renders (50 spp at sample_offset 450), bit for bit,
      at the gpu and the cpu-mt preset: one budgeted pass over every lane
      of the image, and the whole batch, scheduled as the main path
      schedules it, on 65536 pixels drawn across the image;
11. sharding (`parallel/dist.py`, `parallel/worker.py`, `entry.py`): local
   ranks on the card at the bench preset, each a process (ranks that
   share the one card time-slice it, so the times are overhead and
   correctness readings, not scaling):
   a. one rank over NCCL on a (1, 1) mesh: the sharded forward
      bit-identical to `render_cuda`, the sharded step's loss and
      gradients to `render_grads_cuda`;
   b. 2 and 4 ranks over gloo on (2, 1), (1, 2), (2, 2) and (4, 1): pixel
      meshes bit-identical to `render_cuda`, sample meshes to the sample
      windows rendered on one device and averaged in rank order (and
      within 1e-6 of `render_cuda`); the step's loss within 1e-6 relative
      (bit for bit on pixel meshes), the same bits on every rank and run
      to run, and its gradients within rtol 2e-5 + atol 1e-6 of one
      device's at 64x32 and, at the bench preset, off the exact float64
      sum of one device's events by at most SHARD_EXACT_FACTOR times one
      device's own excess (see there); the warm cache hit per slab;
      render_kernel, grad_replay, grad_reverse and grad_reduce launched on
      every rank; a 24x16 camera on (4, 1), whose slab 3 lies past the
      image and launches no backward kernel; the forward's and the step's
      seconds, the collectives' share and the peak memory of each rank;
   c. the CLI under torchrun, 2 ranks: `--preset bench --mesh 2`, whose PPM
      must be phase 6's bytes, and the batched path `--mesh 1,2 --spp 64
      --spp-batch 15 --checkpoint`, whose checkpoint must hold each batch's
      rank-order composite folded, bit for bit;
   d. `entry.dryrun_multichip(2)` and `(4)` on the card;
12. the book milestones (`models/milestones.py`, `probes/closed_form.py`):
   a. every milestone the final integrator renders (`MILESTONE_RENDERS`:
      the sky alone, the sphere over the ground, the metal trios, the
      glass trios solid and hollow, the wide two spheres, and the hollow
      trio under the positioned cameras, wide, zoomed and with the
      aperture lens) at the book's size, 400 wide, 100 spp, depth 50,
      through `render_cuda` (launch counts from 0, finite pixels, the warm
      render's seconds and Mrays/s, and its bound over the active slots,
      beside the bound over all 128 that the sweep tests);
   b. the kernel against the plain version on 1024 pixels drawn across
      each of those ten images, scheduled as the main path schedules
      them, bit for bit;
   c. the five closed-form probes of tests/test_pallas.py through the
      kernel, each within its closed form and bit-identical to the plain
      version;
   d. the four shading renders (both v2 dielectric modes) at full width on
      the card with the JAX package's spp and depth; the same renders'
      first SHADING_CPU_SPP samples against the same function on the CPU,
      in 12x6 block means and the share of pixels apart (SHADING_CARD_GATE,
      SHADING_CARD_SHARE), which the card's render under another seed must
      miss; and `first_gradient_image` at 1920x1080 byte for byte.
13. the gallery and the scheduling sweep (`scripts/render_artifact.py`,
   `scripts/render_gallery.py`, `utils/manifest.py`, `utils/png.py`,
   `probes/sweep_sched.py`):
   a. the cpu preset (1200x800, aperture 0.1) at 500 spp in 5 batches of
      100 through `render_preset` on the reference's exact scene:
      render_kernel launched in every batch, the PNG read back byte-equal
      to the quantized image, and within the gates of
      tests/test_golden_fullres.py against the reference's own render
      (MAD < 2.5, p99 <= 25, max <= 220 8-bit levels);
   b. each of the four presets (cpu, gpu, gpu-old, cpu-mt) at 500 spp on
      the scene of the TPU's render in gallery/, under render seeds 0 and
      1: noise = MAD(seed 0, seed 1); MAD(seed 0, the TPU's render) must
      lie below TPU_GATE x noise, MAD(seed 1, the TPU's render) must not
      (the wrong pairing); render_kernel launched in every batch;
   c. the manifest beside the renders: one entry a render with the sources
      digest, the git commit and the card; the digest moves with one byte
      of a copied render_device.cuh, not with a docstring;
   d. the scheduling sweep's default grid at the bench preset, cold, 1
      untimed + 3 timed renders a configuration, every image equal to the
      default schedule's, one launch a pass; best ms and Mrays/s each;
   e. the kernel against the plain version at the gallery's last batch
      (100 spp at sample_offset 400) on GALLERY_LANES pixels drawn across
      the cpu preset's image (the reference scene, the aperture lens) and
      the gpu preset's (the JAX scene), bit for bit.
14. the differentiable render under torch.autograd (`ops/integrator.py`,
   `ops/render.py`, `parallel.dist.render_grads_pcg`), plain PyTorch on the
   card that must launch no kernel (launch counts from 0 in each part):
   a. at 64x32, spp 4, depth 8: `render(differentiable=True)` bit-identical
      to `render_cuda` (the kernel), and `render_grads_pcg`' loss and
      gradients against `render_grads_cuda`'s (the loss within 1e-6
      relative, each field within GRAD_GATE relative L2);
   b. at the bench preset, on phase 7b's 16384 drawn pixels: `render_pixels`
      bit-identical to those pixels of `render_cuda`, and the autograd
      gradient for the image cotangent that 7b's per-sample cotangent `g`
      stands for (g · spp) against `build.grad_pass` on the same lanes,
      each field within GRAD_GATE;
   c. the slice at full width: `render_grads_pcg` once at the bench preset
      with a zero target at the default chunk (seconds, step Mrays/s, peak
      memory), the loss within 1e-6 relative of `render_grads_cuda`'s and
      each field but ior within GRAD_GATE; ior (on the JAX cover_scene(0)
      a sum whose terms cancel to a seventh of their magnitude) held as
      phase 11b holds a mesh, to the exact float64 sum of the kernels'
      events: the kernels within GRAD_GATE of it, the autograd step within
      EXACT_GRAD_FACTOR times the larger of GRAD_GATE and the kernels' own
      distance; then the forward alone (`render`, no tape), timed and
      bit-identical to `render_cuda` at full width;
   d. `inverse_render --backend pallas --grad autograd` on the card: exit 0.
15. the jnp backend on threefry keys (`ops/threefry.py`,
   `ops/cuda_threefry.py`, `csrc/threefry_render_kernel.cu`):
   a. `cover_scene(0)` equals the committed table of the JAX scene, and
      the bench preset's scene is it (485 active, 396/72/17);
   b. the main path: the CLI at the bench preset with `--backend jnp`
      (threefry_render_kernel launched, render_kernel not; the first and
      the timed render's seconds and Mrays/s);
   c. the kernel against its plain version on 16384 bench pixels drawn
      across the image, phase 3's gate and then bit for bit, the work map
      too; fewer pixels than a block, one pixel, one sample and a sample
      window at offset 5 likewise; the whole bench image in identity,
      reversed and random pixel order: the same bits and work map;
   d. the kernel's registers, spills, blocks an SM, persistent grid and
      SASS per sphere test, its time on the whole bench image, its bound
      from the sweeps it counted (and at 17 operations a test, -2 (o.c)
      taken in each),
      and the queue's ramp and tail (the image once and twice in a launch);
   e. the gallery's jnp image at full size (cpu preset, 500 spp) under
      render seeds 0 and 1 against the TPU's in `gallery/`: seed 0 within
      TPU_GATE x noise, seed 1 not.
16. the keyed gradient on threefry keys (`parallel.dist.render_grads`,
   `ops/cuda_threefry.py`, `csrc/threefry_grad_kernel.cu`: the recording
   forward and the reverse kernels, then grad_kernel.cu's reduction; phase
   2 prints their registers and spills and the recording forward's
   blocks an SM):
   a. at 64x32 on the inverse-render example's world (spp 4, depth 8, its
      damaged albedos and target) and on cover_scene(0) (spp 2, zero
      target): the recording forward's image and work map the bits of
      threefry_render_kernel's, the three kernels launched once (and a
      re-run of the recording forward at most once, the first time), the
      loss the bits of the loss of threefry_render_kernel's image, each
      field within GRAD_GATE of `render_grads_autograd` on the card (which
      launches nothing);
   b. at the bench preset on phase 15c's 16384 drawn pixels: the recording
      forward's image and work map the forward kernel's bits and the plain
      recording's; its records in logical order (links and
      `build.path_slots`) the plain replay's words 0-13 bit for bit; the
      reverse's events within ADJOINT_GATE of the plain reverse's (winners
      equal; by distance from the path's end), the plain per-path reverse
      on the kernel's arena the plain reverse's bits; the reduction the
      ordered plain reduction's bits; the gradient bit-identical run to
      run, for a shuffled pixel order and through a forced overflow (an
      arena of 1024 records: one re-run);
   c. the main path of the slice: `render_grads` at the bench preset with a
      zero target, cold and warm (seconds, Mrays/s, launches, re-runs, the
      step's own peak memory), one warm step under torch.profiler (each
      kernel's device ms, no replay kernel, the idle share), each kernel's
      bound from the step's sweeps and paths and its share of it, the
      recording forward's bench image the forward kernel's bits; with
      `--parent`, the parent checkout's warm step (`probes/keyed_step.py`
      in fresh processes, parent, this, this, parent) and its gradient,
      held to this one's bit for bit; then `render_grads_autograd` once on
      the card (KEYED_ORACLE_CHUNK pixels a chunk): the loss the kernels'
      bits, each field within GRAD_GATE but EXACT_GRAD_FIELDS, held as 14c
      holds them to the exact float64 sum of the kernels' events;
   d. the inverse-render example's default (`--backend jnp`) on the card:
      exit 0, the three kernels launched;
   e. the keyed step in 2 gloo ranks on (2, 1) and (1, 2) at 64x32 against
      one process: the image one process's bits (pixels) or the windows'
      rank-order mean's (samples), the loss and gradients as phase 11b
      holds them at 64x32, the kernels launched on every rank.

Then it prints nvidia-smi's line, a JSON line of per-kernel results, and
last `{"ok": true, "device": {...}}`. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import sys
import tempfile
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


def backward_bounds(n_events, n_slots, n_active, n_lanes):
    """The least times of the replay and the reverse for this run's
    bounces: the replay's sweep (15 operations per test of an active
    sphere, one sweep per bounce) against its inputs and 64-byte records;
    the reverse's record reads and event writes (its operations are not
    counted: it runs no sweep, and the bytes bound it, see PERF.md)."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    table = 4.0 * (16 * n_slots + 24)
    replay = kp.bound_ms(float(n_events) * n_active * kp.OPS_PER_SPHERE_TEST,
                         table + 16.0 * n_lanes + 64.0 * n_events)  # pix, ev_start, ev_count per lane
    reverse = kp.bound_ms(0.0, table + 24.0 * n_lanes + 128.0 * n_events)  # g, ev_start, ev_count per lane
    return replay, reverse


def reduce_bounds(events, n_slots):
    """The reduction's least times on `events` (`reduce_parts.reduce_bounds_ms`):
    the bytes these events need (32 for an event with no sphere, 64 for the
    others) and every event read whole (64 bytes each)."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.probes import reduce_parts as rp

    w = events[:, 0].contiguous().view(torch.int32)
    return rp.reduce_bounds_ms(events.shape[0], int(((w >= 0) & (w < n_slots)).sum()), n_slots)


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
    events, split = check_split(p_mat, cam_vec, scalars, pix, g, work, spp, depth, "phase 7a")
    check_reduce_bits(events, p_mat.shape[1], "phase 7a")
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
    check_reduce_bits(events, p_mat.shape[1], "phase 7b")
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
    reduce_bound, reduce_bound_whole = reduce_bounds(events, p_mat.shape[1])
    return dict(out, errs=errs, reduce_ms=reduce_ms, plain_ms=plain_ms, reduce_plain_ms=reduce_plain_ms,
                reduce_err=reduce_err, reduce_abs_err=reduce_abs_err, reduce_bound=reduce_bound,
                reduce_bound_whole=reduce_bound_whole, reduce_library_ms=library_ms)


def check_reduce_bits(events, n_slots, label):
    """`grad_reduce` on `events` bit-identical to `_reduce_events_ordered`,
    the kernel's order in plain PyTorch."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    got = build.grad_reduce(events, n_slots).view(torch.int32)
    want = cg._reduce_events_ordered(events, n_slots).view(torch.int32)
    check(torch.equal(got, want), f"{label}: grad_reduce differs from the ordered plain reduction in "
                                  f"{int((got != want).sum())} of {got.numel()} words (bit-identical required)")


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


def phase_train_step(scene, cam, parent=None, warm_reps=3):
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
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    t0 = time.perf_counter()
    (loss, work), grads = cg.render_grads_cuda(params, scene, cam, target, return_work=True)
    torch_sync()
    cold_s = time.perf_counter() - t0
    cold_segments = torch.cuda.memory_stats()["segment.all.allocated"] - segments
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
    bounds = (*backward_bounds(n_events, p_mat.shape[1], scene.num_active, pix.numel()),
              *reduce_bounds(events, p_mat.shape[1]))
    # The reduction at full width: bits, its two kernels apart, and the
    # parent tree's pair on the same events in turns (with --parent).
    from ray_tracing_in_one_weekend_tpu_torch.probes import reduce_parts as rv
    from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings as sr
    from ray_tracing_in_one_weekend_tpu_torch.probes.sweep_variants import Build

    check_reduce_bits(events, p_mat.shape[1], "phase 7c")
    pair = [Build("this tree", build)]
    if parent is not None:
        mod = sr.load_build(parent)
        mod.build()
        parent_out = mod.grad_reduce(events, p_mat.shape[1])
        check(torch.equal(parent_out.view(torch.int32), build.grad_reduce(events, p_mat.shape[1]).view(torch.int32)),
              "phase 7c: the parent's reduction gives other bits")
        pair.append(Build("parent", mod))
    reduce_parts = rv.pair_times(pair, events, p_mat.shape[1], rounds=5)
    event_stats = rv.event_stats(events, p_mat.shape[1])
    return dict(cold_s=cold_s, warm_s=warm, mrays=[rays / t / 1e6 for t in warm],
                cold_mrays=rays / cold_s / 1e6, launches=launches, peak_gb=peak_gb,
                loss=float(loss), n_events=n_events, replay_ms=replay_ms, cold_again_s=cold_again_s,
                cold_segments=cold_segments,
                reverse_ms=reverse, replay_bound=bounds[0], reverse_bound=bounds[1],
                reduce_bound=bounds[2], reduce_bound_whole=bounds[3], reduce_ms=reduce_ms,
                reduce_library_ms=library_ms,
                reduce_parts=reduce_parts, event_stats=event_stats)


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


@contextlib.contextmanager
def batch_render(fn):
    """While open, `utils/checkpoint.accumulate` renders its batches with
    `fn` in place of `render_cuda`: how phase 10 runs the long render's
    accumulation through the plain version, or with injected faults."""
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt

    real = ckpt.render_cuda
    ckpt.render_cuda = fn
    try:
        yield real
    finally:
        ckpt.render_cuda = real


# 10b: the resumed gpu-preset image against the exact mean of its 500
# samples, max abs of the linear image: about ten float32 ulps at 1.0, one
# a fold. One 500-spp render is not the yardstick: its float32 sum of 500
# samples errs by more (4.9e-6 at 96x54 on the CPU, where the batched
# image errs by 4.8e-7), so it is held to the same samples' float32 sum.
LONG_RENDER_GATE = 2e-6


def phase_long_render_small():
    """10a and 10c, at 150x100, spp 64, batches of 10 (the bench preset's
    scene, camera and depth): the accumulation through the kernel against
    the same accumulation through the plain version (bit-identical, one or
    more launches a batch); then one NaN batch and one raised batch
    injected under `render_resilient`, whose recovered image must be the
    fault-free run's bits."""
    import dataclasses
    import functools

    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
    from ray_tracing_in_one_weekend_tpu_torch.utils import resilient
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    config = dataclasses.replace(PRESETS["bench"], image_width=150, samples_per_pixel=64)
    scene, cam = make_scene_from_config(config, DEVICE), make_camera_from_config(config, DEVICE)

    def accumulate():
        state, launches = ckpt.new_state(cam, DEVICE), []
        while state.spp_done < config.samples_per_pixel:
            before = build.LAUNCHES["render_kernel"]
            state = ckpt.accumulate(state, scene, cam, config.seed,
                                    min(10, config.samples_per_pixel - state.spp_done))
            launches.append(build.LAUNCHES["render_kernel"] - before)
        torch_sync()
        return state, launches

    cr._WORK_CACHE.clear()
    kernel, launches = accumulate()
    check(len(launches) == 7 and min(launches) >= 1,
          f"phase 10a: render_kernel launches a batch {launches}, one or more each required")
    cr._WORK_CACHE.clear()
    with batch_render(functools.partial(cr.render_with, cr._render_pass_plain)):
        t0 = time.perf_counter()
        plain, plain_launches = accumulate()
        plain_s = time.perf_counter() - t0
    check(sum(plain_launches) == 0, "phase 10a: the plain accumulation launched the kernel")
    check(torch.equal(kernel.accum, plain.accum) and torch.equal(kernel.work, plain.work),
          f"phase 10a: the kernel's accumulated image differs from the plain version's in "
          f"{int((kernel.accum != plain.accum).sum())} values (bit-identical required)")

    calls = []

    def flaky(*a, **kw):
        calls.append(kw["sample_offset"])
        if len(calls) == 4:
            raise RuntimeError("injected transient device fault")
        colors, work = real(*a, **kw)
        if len(calls) == 2:
            colors = colors.clone()
            colors[0, 0, 0] = float("nan")
        return colors, work

    stats = resilient.RetryStats()
    with batch_render(flaky) as real:
        recovered = resilient.render_resilient(scene, cam, config.seed, spp_batch=10, max_retries=1,
                                               stats=stats, log=lambda *a: None)
    check(stats.retries == 2 and stats.batches == 7,
          f"phase 10c: {stats.retries} retries over {stats.batches} batches, 2 over 7 expected")
    check([k for _, k, _ in stats.failures] == ["BatchCorruptError", "RuntimeError"],
          f"phase 10c: failures {stats.failures}")
    check(torch.equal(recovered, kernel.image),
          "phase 10c: the recovered image differs from the fault-free batched run")
    return dict(launches=launches, plain_s=plain_s, retried_at=[s for s, _, _ in stats.failures],
                calls=len(calls))


def phase_long_render_resume(out_dir):
    """10b: the long render's main path through the CLI at the gpu preset
    (1920x1080, 500 spp, the cover scene): `--checkpoint FILE --spp 250`,
    then the same with `--spp 500`, an interrupted run resumed; the launch
    counts set to 0 before and read after. The resumed image within
    LONG_RENDER_GATE linear of the exact (float64) mean of the same 500
    samples, each rendered alone, and at most one 8-bit level off one
    500-spp `render_cuda`, which must be those samples' float32 sum. Then
    the time of one checkpoint save."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
    from ray_tracing_in_one_weekend_tpu_torch.utils import cli, ppm
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        make_camera_from_config,
        make_scene_from_config,
    )

    path, out = out_dir / "long_render.npz", out_dir / "long_render.ppm"
    path.unlink(missing_ok=True)
    build.reset_launches()
    first = cli.run(["--preset", "gpu", "--spp", "250", "--checkpoint", str(path), "--no-output"])
    check(ckpt.load(str(path), DEVICE).spp_done == 250, "phase 10b: the checkpoint does not hold 250 spp")
    resumed = cli.run(["--preset", "gpu", "--checkpoint", str(path), "--out", str(out)])
    launches = dict(build.LAUNCHES)
    check(launches["render_kernel"] >= first.batches + resumed.batches,
          f"phase 10b: {launches['render_kernel']} render_kernel launches for "
          f"{first.batches + resumed.batches} batches")
    check(first.session_spp == 250 and resumed.session_spp == 250,
          f"phase 10b: sessions of {first.session_spp} and {resumed.session_spp} spp")
    c = resumed.config
    check(out.read_bytes().startswith(f"P3\n{c.image_width} {c.image_height}\n255\n".encode()),
          "phase 10b: bad PPM header")
    scene, cam = make_scene_from_config(c, DEVICE), make_camera_from_config(c, DEVICE)
    torch_sync()
    t0 = time.perf_counter()
    one = cr.render_cuda(scene, cam, seed=c.seed)
    torch_sync()
    one_s = time.perf_counter() - t0
    # Sample k alone (sample_offset k, spp 1) is the value both renders add:
    # its float32 running sum is the one-piece render's bits, its float64
    # sum the exact mean.
    total, exact = torch.zeros_like(one), torch.zeros_like(one, dtype=torch.float64)
    for k in range(c.samples_per_pixel):
        x = cr.render_cuda(scene, cam, seed=c.seed, spp=1, sample_offset=k, warm=False)
        total, exact = total + x, exact + x.double()
    check(torch.equal(total * (1.0 / c.samples_per_pixel), one),
          "phase 10b: one 500-spp render is not the float32 sum of its samples rendered one by one")
    exact /= c.samples_per_pixel
    img = resumed.image
    check(bool(torch.isfinite(img).all()) and img.shape == one.shape, "phase 10b: bad resumed image")
    err = float((img.double() - exact).abs().max())
    check(err <= LONG_RENDER_GATE,
          f"phase 10b: resumed image {err:.3e} off the exact mean of its samples (gate {LONG_RENDER_GATE})")
    u8, u8_one = to_uint8(img).int(), to_uint8(one).int()
    levels = (u8 - u8_one).abs()
    check(int(levels.max()) <= 1, f"phase 10b: an 8-bit pixel is {int(levels.max())} levels off one piece")
    check(torch.equal(torch.from_numpy(ppm.read_ppm(str(out))).int(), u8.cpu()),
          "phase 10b: the PPM is not the resumed image")
    # What persisting a batch costs: the checkpoint's save (zlib-compressed
    # npz, the JAX package's format), and np.savez of the same arrays.
    state = ckpt.load(str(path), DEVICE)
    t0 = time.perf_counter()
    ckpt.save(state, str(path))
    save_s = time.perf_counter() - t0
    raw = out_dir / "long_render_raw.npz"
    t0 = time.perf_counter()
    np.savez(raw, accum=state.accum.cpu().numpy(), spp_done=np.asarray(state.spp_done, np.int32),
             work=state.work.cpu().numpy())
    save_raw_s = time.perf_counter() - t0
    sizes = (path.stat().st_size / 1e6, raw.stat().st_size / 1e6)
    raw.unlink()
    return dict(first=first, resumed=resumed, launches=launches, max_abs_err=err, one_s=one_s,
                one_err=float((one.double() - exact).abs().max()),
                vs_one=float((img - one).abs().max()), u8_off=int((levels > 0).sum()),
                u8_values=levels.numel(), save_s=save_s, save_raw_s=save_raw_s, sizes=sizes)


def phase_long_render_times(preset, rounds=3):
    """10d: the CLI's batched path at `preset` with --no-output (seconds a
    batch, the first apart; steady Mrays/s; peak device memory), then the
    warm-cache fill's share of a batch: the fill alone (`_perm_from_hint`
    of a batch's cost map, CUDA events) and one batch with warm=True
    against warm=False in turns (host clock to a synchronize)."""
    import statistics

    import torch

    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
    from ray_tracing_in_one_weekend_tpu_torch.utils import cli
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        make_camera_from_config,
        make_scene_from_config,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = cli.run(["--preset", preset, "--no-output"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    c = res.config
    batch = c.samples_per_pixel // 10
    steady = c.image_width * c.image_height * (res.session_spp - batch) / sum(res.batch_s[1:]) / 1e6
    scene, cam = make_scene_from_config(c, DEVICE), make_camera_from_config(c, DEVICE)
    state = ckpt.accumulate(ckpt.new_state(cam, DEVICE), scene, cam, c.seed, batch)
    padded = -(-cam.num_pixels // cr.DEFAULT_TILE) * cr.DEFAULT_TILE
    hint = torch.zeros(padded, dtype=torch.float32, device=DEVICE)
    hint[:cam.num_pixels] = state.work.reshape(-1)
    fill_ms = cuda_ms(lambda: cr._perm_from_hint(hint), reps=5)
    times = {True: [], False: []}
    cr._WORK_CACHE.clear()
    for _ in range(rounds):
        for warm in (True, False):
            torch_sync()
            t0 = time.perf_counter()
            ckpt.accumulate(state, scene, cam, c.seed, batch, warm=warm)
            torch_sync()
            times[warm].append(time.perf_counter() - t0)
            cr._WORK_CACHE.clear()  # the next warm=True batch misses, as every batch does
    warm_s, cold_s = statistics.median(times[True]), statistics.median(times[False])
    return dict(config=c, batch_s=res.batch_s, steady_mrays=steady, total_s=res.render_s,
                mrays=res.mrays_per_s, peak_gb=peak_gb, fill_ms=fill_ms, batch_warm_s=warm_s,
                batch_nowarm_s=cold_s, fill_share=fill_ms / 1e3 / warm_s,
                fill_share_turns=(warm_s - cold_s) / warm_s)


# 10e: the last batch of a 500-spp render at the gpu and cpu-mt presets:
# 50 samples from sample 450 on.
LONG_BATCH, LONG_OFFSET = 50, 450


def phase_long_render_kernel_vs_plain(preset, budget=8, n_lanes=65536):
    """10e: render_kernel against `_render_pass_plain` at `preset`'s shapes
    for its last batch (spp LONG_BATCH at sample_offset LONG_OFFSET), bit
    for bit as phase 6 holds them. First one pass over every lane of the
    image, stopped after `budget` iterations: the plain version's cost
    grows with lanes times iterations, and the whole batch on every lane
    is out of its reach. Then the whole batch, scheduled as the main path
    schedules it (`_multipass`: the budgeted pass, the compaction, the
    last pass), through the kernel and through the plain version, on
    `n_lanes` pixels drawn across the image (numpy, seed 0): the kernel
    takes pixel ids as data, so the subset runs the image's own ids."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.utils import compare
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    label = f"phase 10e ({preset})"
    c = PRESETS[preset]
    scene, cam = make_scene_from_config(c, DEVICE), make_camera_from_config(c, DEVICE)
    spp, depth, n, tile = LONG_BATCH, cam.max_depth, cam.num_pixels, cr.DEFAULT_TILE
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    table = p_mat.T.contiguous()

    sf, si = cr._init_state(0, -(-n // tile) * tile, n, spp, DEVICE)
    args = (cam_vec, (c.seed, 0, LONG_OFFSET, budget), sf, si, tile, spp, depth)
    of_k, oi_k = build.render_pass(table, *args)
    t0 = time.perf_counter()
    of_p, oi_p = cr._render_pass_plain(p_mat, *args)
    torch_sync()
    full_plain_s = time.perf_counter() - t0
    full = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
    check(full.flipped_frac == 0.0 and full.max_abs_err == 0.0
          and torch.equal(of_k[cr._SF_WORK], of_p[cr._SF_WORK]),
          f"{label}: a pass over all {n} lanes (budget {budget}) not bit-identical to plain: {full}")
    full_iters = float(of_k[cr._SF_WORK].double().sum())
    started = int(oi_k[cr._SI_STARTED, :n].long().sum())
    del of_k, oi_k, of_p, oi_p

    sub = drawn_lanes_kernel_vs_plain(p_mat, cam_vec, (c.seed, 0, LONG_OFFSET, 0), n, spp, depth, n_lanes,
                                      label)
    return dict(n=n, budget=budget, full_plain_s=full_plain_s, full_iters=full_iters, started=started,
                n_lanes=n_lanes, sub_iters=sub["iters"], sub_s=sub["kernel_s"], sub_plain_s=sub["plain_s"])


def drawn_lanes_kernel_vs_plain(p_mat, cam_vec, scalars, n, spp, depth, n_lanes, label):
    """A render of `n_lanes` pixels drawn across an image of `n` (numpy,
    seed 0), scheduled as the main path schedules it (`_multipass`: the
    budgeted pass, the compaction, the last pass), through the kernel and
    through the plain version, bit for bit: the kernel takes pixel ids as
    data, so the subset runs the image's own ids and streams. Returns the
    lane-iterations and both times."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

    pix = np.random.default_rng(0).choice(n, size=n_lanes, replace=False)
    sf, si = cr._init_state(0, n_lanes, n, spp, DEVICE)
    si[cr._SI_PIX] = torch.from_numpy(pix).to(DEVICE, torch.int32)
    runs = {}
    for name, pass_fn in (("kernel", cr._render_pass), ("plain", cr._render_pass_plain)):
        before = build.LAUNCHES["render_kernel"]
        torch_sync()
        t0 = time.perf_counter()
        rad, work = cr._multipass(p_mat, cam_vec, scalars, sf.clone(), si.clone(), cr.DEFAULT_TILE, spp,
                                  depth, cr._default_budget(spp), cr.DEFAULT_PASSES, pass_fn)
        torch_sync()
        runs[name] = (rad, work, time.perf_counter() - t0, build.LAUNCHES["render_kernel"] - before)
    (rad_k, work_k, kernel_s, launches), (rad_p, work_p, plain_s, plain_launches) = runs.values()
    check(launches == cr.DEFAULT_PASSES and plain_launches == 0,
          f"{label}: {launches} kernel and {plain_launches} plain launches for a render of "
          f"{cr.DEFAULT_PASSES} passes")
    check(torch.equal(rad_k, rad_p) and torch.equal(work_k, work_p),
          f"{label}: the render of {n_lanes} drawn lanes differs from plain in "
          f"{int((rad_k != rad_p).sum())} radiance values (bit-identical required)")
    return dict(iters=float(work_k.double().sum()), kernel_s=kernel_s, plain_s=plain_s)


PROBE_REPLACES = {
    "chain_fma": "scripts/perf_probe.py:47",
    "fma_peak": "scripts/kernel_parts_probe.py:67",
    "sweep_probe": "scripts/kernel_parts_probe.py:101",
    "gather_probe": "scripts/kernel_parts_probe.py:148",
    "skinny_probe": "scripts/kernel_parts_probe.py:196",
    "skinny_probe_default": "scripts/kernel_parts_probe.py:196",
}


# Steps of phase 9's chain at a length its unrolled loop leaves a remainder
# of (1000 = 7 x 128 + 104), and the least FFMA share of that loop's SASS.
CHAIN_REMAINDER = 1000
CHAIN_FFMA_SHARE = 0.9


def chain_digest(chain, xs) -> str:
    """sha256 of the bytes of `chain(x, 512)` for each x of `xs`, in turn."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    h = hashlib.sha256()
    for x in xs:
        h.update(chain(x, kp.CHAIN).cpu().numpy().tobytes())
    return h.hexdigest()


def phase_chain(res, parent=None):
    """9: chain_fma_kernel at CHAIN_REMAINDER steps against its plain version
    on seeded inputs of [128, 196] and [128, 2048], its reading, and the
    sha256 of its outputs at the probe path's 2048 columns and 512 steps
    (on the probe path's ones, which give one value, then on the seeded
    [128, 2048]), with `parent` also the parent checkout's kernel's."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings as sr

    dev = torch.device(DEVICE, 0)
    rng = np.random.default_rng(0)
    err = 0.0
    for tile in (196, kp.JAX_TILE):
        x = torch.from_numpy(rng.uniform(0.5, 2.0, (128, tile)).astype(np.float32)).to(dev)
        got = kp.chain_fma(x, CHAIN_REMAINDER)
        want = kp.chain_fma_plain(x, CHAIN_REMAINDER)
        e = kp.error("chain_fma", got, want)
        check(e <= kp.GATES["chain_fma"], f"phase 9: chain_fma at [128, {tile}], {CHAIN_REMAINDER} steps: "
                                          f"error {e:.2e} > {kp.GATES['chain_fma']}")
        err = max(err, e)
    reading = kp.chain_reading(res.log, sr.sass_of(res.path))
    share = reading.ffma_share
    check(not reading.sass or (share is not None and share >= CHAIN_FFMA_SHARE),
          f"phase 9: {reading.line()}: the main loop is below {CHAIN_FFMA_SHARE} FFMA")
    xs = (kp.inputs("chain_fma", kp.JAX_TILE, dev)[0], x)
    digest = chain_digest(build.chain_fma, xs)
    parent_digest = chain_digest(sr.load_build(parent).chain_fma, xs) if parent is not None else None
    check(parent_digest in (None, digest),
          f"phase 9: chain_fma's {kp.JAX_TILE}-column output {digest} is not the parent's {parent_digest}")
    return dict(remainder_err=err, reading=reading, sha256=digest, parent_sha256=parent_digest)


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
    if "chain" in v:
        c = v["chain"]
        entry.update(c["reading"].fields(), chain_remainder_steps=CHAIN_REMAINDER,
                     chain_remainder_err=c["remainder_err"], sha256_2048x512=c["sha256"],
                     parent_sha256_2048x512=c["parent_sha256"])
    return entry


# ---------------------------------------------------------------------------
# 11. sharding on the card (parallel/dist.py, parallel/worker.py, entry.py)
# ---------------------------------------------------------------------------

# Each local launch, torchrun run and dry run of phase 11 must end within this.
SHARD_TIMEOUT = 300.0
# Sharded against one device (tests/test_pallas_grad.py:171-181,
# tests/test_pallas_dist.py:43): gradients elementwise, the loss relative,
# a sample mesh's image absolute.
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL, SHARD_LOSS_RTOL, SHARD_IMAGE_ATOL = 2e-5, 1e-6, 1e-6, 1e-6
# At the bench preset one device's own float32 gradient is about one gate
# (the elementwise rtol/atol above) off the exact sum of its events: sphere
# 303's center x sums to -1.29e-4 from far larger terms, and one device
# gives -1.28e-4 (`probes/shard_error.py`, H100). Any other summation order
# is as far off, so there the sharded gradient is held to that exact sum,
# at most SHARD_EXACT_FACTOR times one device's own excess over the gate
# (at least one gate); the gate against one device holds at 64x32.
SHARD_EXACT_FACTOR = 2.0
PATH_KERNELS = ("render_kernel", "grad_replay", "grad_reverse", "grad_reduce")
GRAD_KERNELS = ("grad_replay", "grad_reverse", "grad_reduce")


def composite(scene, cam, spp, n_smp, sample_offset=0):
    """The S sample windows of a sample axis rendered on one device and
    averaged in rank order: what a sample mesh must give bit for bit."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

    part = spp // n_smp
    wins = [cr.render_cuda(scene, cam, spp=part, sample_offset=sample_offset + s * part)
            for s in range(n_smp)]
    out = wins[0]
    for w in wins[1:]:
        out = out + w
    return out / n_smp


def grad_excess(got, want):
    """max over elements of |got - want| / (atol + rtol |want|), in float64:
    at most 1 passes the elementwise gradient gate."""
    from ray_tracing_in_one_weekend_tpu_torch.probes.shard_error import excess

    return excess(got, want)[0]


class OneDevice:
    """The one-device references of a scene and camera, each computed once."""

    def __init__(self, scene, cam):
        self.scene, self.cam, self._cache = scene, cam, {}

    def get(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def target(self):
        import torch

        return torch.zeros(self.cam.image_height, self.cam.image_width, 3, device=DEVICE)

    def image(self):
        from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

        return self.get("image", lambda: cr.render_cuda(self.scene, self.cam).cpu())

    def composite(self, n_smp):
        return self.get(("composite", n_smp), lambda: composite(
            self.scene, self.cam, self.cam.samples_per_pixel, n_smp).cpu())

    def grads(self):
        from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

        def run():
            loss, grads = cg.render_grads_cuda(cg.scene_params(self.scene), self.scene, self.cam,
                                               self.target())
            return loss.cpu(), {k: v.cpu() for k, v in grads.items()}

        return self.get("grads", run)

    def exact(self):
        """The step's gradient with its events summed in float64, and one
        device's excess over the gate against it, by field."""
        from ray_tracing_in_one_weekend_tpu_torch.probes.shard_error import exact_grads

        def run():
            exact = {k: v.cpu() for k, v in exact_grads(self.scene, self.cam, self.target()).items()}
            return exact, {k: grad_excess(g, exact[k]) for k, g in self.grads()[1].items()}

        return self.get("exact", run)


def check_render(label, mesh, ranks, ref, backend):
    """One mesh's sharded renders (every rank's) against one device -> the
    image's max abs off `render_cuda`."""
    import torch

    check(all(r["backend"] == backend for r in ranks),
          f"{label}: backend {[r['backend'] for r in ranks]}, expected {backend}")
    img = ranks[0]["image"]
    check(all(torch.equal(r["image"], img) for r in ranks), f"{label}: the ranks' images differ")
    check(all(all(r["same"]) for r in ranks), f"{label}: a repeated render gave other bits")
    check(all(r["hits"][1:] == [True] * (len(r["hits"]) - 1) and not r["hits"][0] for r in ranks),
          f"{label}: warm-cache hits {[r['hits'] for r in ranks]}, a miss then hits expected")
    one = ref.image()
    if mesh[1] == 1:
        check(torch.equal(img, one), f"{label}: the pixel mesh's image is not render_cuda's bits")
        return 0.0
    check(torch.equal(img, ref.composite(mesh[1])),
          f"{label}: the sample mesh's image is not the rank-order composite's bits")
    err = float((img - one).abs().max())
    check(err <= SHARD_IMAGE_ATOL, f"{label}: image {err:.2e} off render_cuda")
    return err


def check_step(label, mesh, ranks, ref, yardstick):
    """One mesh's sharded steps (every rank's) against one device: the same
    bits on every rank and run to run, the loss within SHARD_LOSS_RTOL (bit
    for bit on a pixel mesh), and the gradients by `yardstick`: "bits" (one
    device's), "one" (the elementwise gate against one device) or "exact"
    (against the exact sum, see SHARD_EXACT_FACTOR). -> readings."""
    import torch

    loss_ref, grads_ref = ref.grads()
    loss = ranks[0]["loss"]
    check(all(torch.equal(r["loss"], loss) for r in ranks), f"{label}: the ranks' losses differ")
    check(all(all(r["same"]) for r in ranks), f"{label}: a repeated step gave other bits")
    loss_err = abs(float(loss) - float(loss_ref)) / float(loss_ref)
    if mesh[1] == 1:
        check(torch.equal(loss, loss_ref), f"{label}: the pixel mesh's loss is not one device's bits")
    check(loss_err <= SHARD_LOSS_RTOL, f"{label}: loss {loss_err:.2e} relative off one device")
    grads = ranks[0]["grads"]
    for k in grads_ref:
        check(all(torch.equal(r["grads"][k], grads[k]) for r in ranks), f"{label}: the ranks' {k} gradients differ")
    vs_one = {k: grad_excess(grads[k], g) for k, g in grads_ref.items()}
    out = {"loss_err": loss_err, "vs_one": vs_one}
    if yardstick == "bits":
        check(all(torch.equal(grads[k], g) for k, g in grads_ref.items()),
              f"{label}: the gradients are not one device's bits")
    elif yardstick == "one":
        for k, e in vs_one.items():
            check(e <= 1.0, f"{label}: {k} gradient off one device by {e:.3f} of rtol "
                            f"{SHARD_GRAD_RTOL} + atol {SHARD_GRAD_ATOL}")
    else:
        exact, one_excess = ref.exact()
        out["vs_exact"] = {k: grad_excess(grads[k], v) for k, v in exact.items()}
        out["one_vs_exact"] = one_excess
        for k, e in out["vs_exact"].items():
            most = SHARD_EXACT_FACTOR * max(1.0, one_excess[k])
            check(e <= most, f"{label}: {k} gradient {e:.3f} of the gate off the exact sum, one device "
                             f"{one_excess[k]:.3f}, at most {most:.3f} allowed")
    return out


def mesh_readings(ranks_render, ranks_step):
    """Times, the collectives' share and peak memory of one mesh's jobs."""
    return {
        "launches": {k: sum(r["launches"][k] for r in ranks_render + ranks_step) for k in PATH_KERNELS},
        "launches_per_rank": [{k: rr["launches"][k] + rs["launches"][k] for k in PATH_KERNELS}
                              for rr, rs in zip(ranks_render, ranks_step)],
        "render_cold_s": max(r["seconds"][0] for r in ranks_render),
        "render_warm_s": [max(r["seconds"][i] for r in ranks_render)
                          for i in range(1, len(ranks_render[0]["seconds"]))],
        "step_s": [max(r["seconds"][i] for r in ranks_step) for i in range(len(ranks_step[0]["seconds"]))],
        "render_coll_share": [r["collective_s"][-1] / r["seconds"][-1] for r in ranks_render],
        "step_coll_share": [r["collective_s"][-1] / r["seconds"][-1] for r in ranks_step],
        "peak_gb": [max(rr.get("peak_bytes", 0), rs.get("peak_bytes", 0)) / 1e9
                    for rr, rs in zip(ranks_render, ranks_step)],
    }


def job(kind, scene, cam, mesh, repeat):
    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker

    return {"job": kind, "mesh": mesh, "scene": worker.scene_spec(scene),
            "camera": worker.camera_spec(cam), "repeat": repeat}


def phase_sharding_ranks(scene, cam, cam24, cam64, out_dir):
    """11a and 11b: the sharded forward and train step in local ranks at the
    bench preset (`cam`); the step at 64x32 (`cam64`); the empty slab at
    24x16 (`cam24`) on (4, 1). -> readings by mesh."""
    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker

    ref, ref24, ref64 = OneDevice(scene, cam), OneDevice(scene, cam24), OneDevice(scene, cam64)
    readings = {}
    # 11a: one rank over NCCL (gloo without a card): every collective adds one term.
    one = "nccl" if DEVICE == "cuda" else "gloo"
    ranks = worker.launch([job("render", scene, cam, (1, 1), 2), job("step", scene, cam, (1, 1), 2)], 1,
                          out_dir / "ranks1", device=DEVICE, backend=one, timeout=SHARD_TIMEOUT)
    r = mesh_readings([ranks[0][0]], [ranks[0][1]])
    r["image_err"] = check_render("phase 11a (1x1)", (1, 1), [ranks[0][0]], ref, one)
    r.update(check_step("phase 11a (1x1)", (1, 1), [ranks[0][1]], ref, "bits"))
    readings["1x1"] = r
    # 11b: 2 and 4 ranks sharing the card, over gloo.
    for n_ranks, meshes in ((2, [(2, 1), (1, 2)]), (4, [(2, 2), (4, 1)])):
        jobs = []
        for m in meshes:
            jobs += [job("render", scene, cam, m, 3), job("step", scene, cam, m, 3),
                     job("step", scene, cam64, m, 1)]
        if n_ranks == 4:
            jobs += [job("render", scene, cam24, (4, 1), 2), job("step", scene, cam24, (4, 1), 2)]
        ranks = worker.launch(jobs, n_ranks, out_dir / f"ranks{n_ranks}", device=DEVICE,
                              timeout=SHARD_TIMEOUT)
        for i, m in enumerate(meshes):
            label = f"{m[0]}x{m[1]}"
            rr, rs, r64 = ([r[3 * i + j] for r in ranks] for j in range(3))
            r = mesh_readings(rr, rs)
            r["image_err"] = check_render(f"phase 11b ({label})", m, rr, ref, "gloo")
            r.update(check_step(f"phase 11b ({label})", m, rs, ref, "exact"))
            r["small"] = check_step(f"phase 11b ({label}, 64x32)", m, r64, ref64, "one")
            for rank, counts in enumerate(r["launches_per_rank"]):
                for k in PATH_KERNELS:
                    check(counts[k] > 0, f"phase 11b ({label}): rank {rank} never launched {k}")
            readings[label] = r
        if n_ranks == 4:
            i = 3 * len(meshes)
            rr, rs = [r[i] for r in ranks], [r[i + 1] for r in ranks]
            r = mesh_readings(rr, rs)
            r["image_err"] = check_render("phase 11b (4x1, 24x16)", (4, 1), rr, ref24, "gloo")
            r.update(check_step("phase 11b (4x1, 24x16)", (4, 1), rs, ref24, "one"))
            per_rank = r["launches_per_rank"]
            for rank in range(3):
                for k in GRAD_KERNELS:
                    check(per_rank[rank][k] > 0, f"phase 11b (24x16): rank {rank} never launched {k}")
            check(all(per_rank[3][k] == 0 for k in GRAD_KERNELS),
                  f"phase 11b (24x16): rank 3's slab lies past the image but launched {per_rank[3]}")
            readings["4x1@24x16"] = r
    return readings


def torchrun(args, timeout=SHARD_TIMEOUT):
    """`torchrun --nproc-per-node 2 -m ray_tracing_in_one_weekend_tpu_torch
    ARGS` from the repo root -> (seconds, stdout, stderr). Fails unless it
    exits 0 in time."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr",
           "127.0.0.1", "--master-port", str(port), "-m", PKG, *args]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"phase 11c: torchrun {' '.join(args)} outlived {timeout:.0f} s") from e
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 11c: torchrun {' '.join(args)} exited {proc.returncode}:\n"
                                f"{proc.stderr[-3000:]}")
    return seconds, proc.stdout, proc.stderr


def phase_sharding_cli(one_device_ppm, out_dir, preset=("--preset", "bench")):
    """11c: the CLI under torchrun, 2 ranks on the card: the bench preset
    (`preset`, the CLI's arguments) on a pixel mesh against the one-device
    CLI's PPM, and the batched path on a sample mesh against the rank-order
    composite of each batch."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
    from ray_tracing_in_one_weekend_tpu_torch.utils import cli
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        make_camera_from_config,
        make_scene_from_config,
    )

    ppm_out = out_dir / "mesh2.ppm"
    ppm_out.unlink(missing_ok=True)
    mono_s, stdout, err = torchrun([*preset, "--mesh", "2", "--out", str(ppm_out)])
    check(stdout == "", "phase 11c: a rank wrote to stdout")
    check(err.count(f"wrote {ppm_out}") == 1, "phase 11c: not exactly one rank wrote the PPM")
    check("backend gloo" in err, "phase 11c: two ranks on one card did not choose gloo")
    check(ppm_out.read_bytes() == one_device_ppm.read_bytes(),
          "phase 11c: the 2-rank pixel mesh's PPM differs from the one-device CLI's")
    render_line = [line for line in err.splitlines() if line.startswith("render: ")]
    check(len(render_line) == 1, f"phase 11c: {len(render_line)} timing lines, one (rank 0's) expected")

    npz = out_dir / "mesh12.npz"
    npz.unlink(missing_ok=True)
    argv = [*preset, "--mesh", "1,2", "--spp", "64", "--spp-batch", "15", "--checkpoint", str(npz),
            "--no-output"]
    batched_s, stdout, err = torchrun(argv)
    check(stdout == "" and err.count("samples 64/64") == 1, "phase 11c: the batched path's progress lines")
    config = cli.config_from_args(cli.build_parser().parse_args(argv))
    scene, cam = make_scene_from_config(config, DEVICE), make_camera_from_config(config, DEVICE)
    state = ckpt.new_state(cam, device=DEVICE)
    batches = []
    while state.spp_done < 64:
        n = min(14, 64 - state.spp_done)  # --spp-batch 15 rounded to the sample axis
        colors = composite(scene, cam, n, 2, sample_offset=state.spp_done)
        state = ckpt.RenderState(state.accum + colors * float(n), state.spp_done + n)
        batches.append(n)
    saved = ckpt.load(str(npz), device=DEVICE)
    check(saved.spp_done == 64, f"phase 11c: the checkpoint holds {saved.spp_done} spp")
    check(torch.equal(saved.accum, state.accum),
          "phase 11c: the 1x2 batched accumulation is not the composites' fold, bit for bit")
    rate = [line for line in err.splitlines() if line.startswith("render: ")]
    check(len(rate) == 1, f"phase 11c: {len(rate)} timing lines of the batched path, one expected")
    return {"mono_s": mono_s, "mono_line": render_line[0], "batched_s": batched_s,
            "batched_line": rate[0], "batches": batches}


def phase_sharding_dryrun():
    """11d: the multi-rank dry run of `entry.py` on the card, 2 and 4 ranks."""
    from ray_tracing_in_one_weekend_tpu_torch import entry

    out = {}
    for n in (2, 4):
        t0 = time.perf_counter()
        res = entry.dryrun_multichip(n, device=DEVICE, timeout=SHARD_TIMEOUT)
        out[n] = {"mesh": res["mesh"], "loss": res["losses"][0], "s": time.perf_counter() - t0}
    return out


# ---------------------------------------------------------------------------
# 12. the book milestones (models/milestones.py, probes/closed_form.py)
# ---------------------------------------------------------------------------

# 12b: pixels drawn across each milestone image for the kernel against the
# plain version, bit for bit. The plain version on the card runs one bounce
# of every busy lane a step, so its time follows the longest pixel's
# bounces more than the number of pixels.
MILESTONE_LANES = 1024
# 12d: the card against the CPU on the same integer draws, per shading
# render: block-mean MAD on the 12x6 grid of tests/test_milestones.py, and
# the share of pixels more than 1e-3 apart in some channel. Read on an H100
# 80GB HBM3 at 700 W: MAD 2.6e-10-1.13e-5 and shares 0-0.0078% (the
# float32 results of a few lanes round apart and their paths part).
SHADING_CARD_GATE = 1e-4
SHADING_CARD_SHARE = 1e-3
# 12d: samples of each shading render held against the CPU. At the JAX
# defaults the CPU versions take 88 s for the five renders, beside an H100.
SHADING_CPU_SPP = 2


def phase_milestones_full_width():
    """12a: every milestone the final integrator renders, at the book's own
    size (400 wide, 100 spp, depth 50), through `render_cuda`: a cold render
    (it fills the schedule cache), then the timed warm one, which must hit
    the cache and give the same bits. The launch counts are set to 0 just
    before and read just after."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.models import milestones as M
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

    results = {}
    build.reset_launches()
    for name in M.MILESTONE_RENDERS:
        label = f"phase 12a ({name})"
        scene, cam = M.milestone_render(name, device=DEVICE)
        before = build.LAUNCHES["render_kernel"]
        torch_sync()
        t0 = time.perf_counter()
        cold, work = cr.render_cuda(scene, cam, return_work=True)
        torch_sync()
        cold_s = time.perf_counter() - t0
        check(cr.warm_cache_hit(scene, cam), f"{label}: the warm render would miss the schedule cache")
        t0 = time.perf_counter()
        warm = cr.render_cuda(scene, cam)
        torch_sync()
        warm_s = time.perf_counter() - t0
        launches = build.LAUNCHES["render_kernel"] - before
        check(launches > 0, f"{label}: render_kernel was never launched")
        check(bool(torch.isfinite(warm).all()), f"{label}: non-finite pixels")
        check(torch.equal(cold, warm), f"{label}: the warm render differs from the cold one")
        # The sweep's operations over the render's lane-iterations, against
        # the packed scene, the camera and the lane state read and written once.
        iters = float(work.double().sum())
        slots, active = scene.num_slots, scene.num_active
        lanes = -(-cam.num_pixels // cr.DEFAULT_TILE) * cr.DEFAULT_TILE
        n_bytes = 4.0 * (cr.P_ROWS * slots + cr.CAM_LEN + 2 * lanes * (cr.SF_ROWS + cr.SI_ROWS))
        # The function needs the active spheres' tests; the sweep tests all
        # 128 slots, and that bound is kept beside it.
        bound = kp.bound_ms(iters * active * kp.OPS_PER_SPHERE_TEST, n_bytes)
        bound_padded = kp.bound_ms(iters * slots * kp.OPS_PER_SPHERE_TEST, n_bytes)
        rays = cam.num_pixels * cam.samples_per_pixel
        results[name] = dict(
            shape=f"{cam.image_width}x{cam.image_height}", spp=cam.samples_per_pixel, depth=cam.max_depth,
            slots=slots, active=active, launches=launches, cold_s=cold_s, warm_s=warm_s,
            mrays_per_s=rays / warm_s / 1e6, iters=iters, bound_ms=bound[0], bound_by=bound[1],
            bound_padded_ms=bound_padded[0], mean=float(warm.mean()))
    total = build.LAUNCHES["render_kernel"]
    check(total == sum(r["launches"] for r in results.values()), "phase 12a: launches outside the renders")
    return results, total


def phase_milestones_kernel_vs_plain(n_lanes=MILESTONE_LANES):
    """12b: every milestone render on `n_lanes` pixels drawn across its
    image, through the kernel and the plain version, bit for bit."""
    from ray_tracing_in_one_weekend_tpu_torch.models import milestones as M
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

    results = {}
    for name in M.MILESTONE_RENDERS:
        scene, cam = M.milestone_render(name, device=DEVICE)
        results[name] = drawn_lanes_kernel_vs_plain(
            cr.pack_scene(scene), cr.pack_camera(cam), (0, 0, 0, 0), cam.num_pixels, cam.samples_per_pixel,
            cam.max_depth, n_lanes, f"phase 12b ({name})")
    return results


def phase_closed_form_probes():
    """12c: the five closed-form probes of tests/test_pallas.py through the
    kernel, each held to its closed form and limit (`probes/closed_form.py`),
    and each image bit-identical to the plain version's."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import closed_form as cf

    readings = {}
    for name in cf.PROBES:
        before = build.LAUNCHES["render_kernel"]
        reading, images = cf.evaluate(name, lambda s, c: cr.render_cuda(s, c, warm=False), DEVICE)
        check(build.LAUNCHES["render_kernel"] > before, f"phase 12c ({name}): render_kernel was never launched")
        check(reading.holds, f"phase 12c: {reading.line()}")
        scene, cams = cf.probe_setup(name, DEVICE)
        for role, cam in cams.items():
            check(torch.equal(images[role], cr.render_with(cr._render_pass_plain, scene, cam, warm=False)),
                  f"phase 12c ({name}, {role}): the kernel's image differs from the plain version's")
        readings[name] = reading
    return readings


def phase_shading_renders():
    """12d: the four shading renders (both v2 modes) at full width on the
    card, with the JAX package's default spp and depth (the close-up at
    200x100): seconds, shape, finite. Then each render's first
    SHADING_CPU_SPP samples (sample s's stream does not depend on spp) on
    the card against the same function on the CPU: block means on the 12x6
    grid within SHADING_CARD_GATE and at most SHADING_CARD_SHARE of the
    pixels more than 1e-3 apart; the card's render under seed 1 must fail
    that check. Then `first_gradient_image` at 1920x1080, byte for byte."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.models import milestones as M
    from ray_tracing_in_one_weekend_tpu_torch.utils import compare

    def renders(device, **kw):
        book = M.book_camera(device=device)
        return {
            "hit_flag": lambda: M.render_hit_flag(M.single_sphere_sky_scene(device=device), book, **kw),
            "normals": lambda: M.render_normals(M.sphere_ground_scene(device=device), book, **kw),
            "hemisphere": lambda: M.render_hemisphere_diffuse(M.sphere_ground_scene(device=device), book, **kw),
            "always_refract": lambda: M.render_v2_dielectric(M.refract_trio_scene(device=device), book, **kw),
            "tir_reflect": lambda: M.render_v2_dielectric(
                M.refract_trio_scene(device=device), M.book_camera(200, aspect_ratio=2.0, device=device),
                mode="tir_reflect", **kw),
        }

    def apart(a, b):
        """(block MAD, share of pixels more than 1e-3 apart) of two images."""
        return compare.grid_mad(a, b), float(((a.cpu() - b).abs().amax(dim=2) > 1e-3).double().mean())

    full = renders(DEVICE)
    card, cpu = renders(DEVICE, spp=SHADING_CPU_SPP), renders("cpu", spp=SHADING_CPU_SPP)
    planted = renders(DEVICE, spp=SHADING_CPU_SPP, seed=1)
    results = {}
    for name in full:
        torch_sync()
        t0 = time.perf_counter()
        img = full[name]()
        torch_sync()
        card_s = time.perf_counter() - t0
        check(img.device.type == "cuda" and img.dtype == torch.float32, f"phase 12d ({name}): dtype or device")
        check(bool(torch.isfinite(img).all()), f"phase 12d ({name}): non-finite pixels")
        few = card[name]()
        t0 = time.perf_counter()
        ref = cpu[name]()
        cpu_s = time.perf_counter() - t0
        check(img.shape == few.shape == ref.shape, f"phase 12d ({name}): shapes {img.shape}, {ref.shape}")
        mad, differ = apart(few, ref)
        check(mad < SHADING_CARD_GATE and differ <= SHADING_CARD_SHARE,
              f"phase 12d ({name}): card vs CPU block MAD {mad:.3e} (gate {SHADING_CARD_GATE}), "
              f"{differ:.4%} of pixels apart (at most {SHADING_CARD_SHARE:.2%})")
        fault = apart(planted[name](), ref)
        check(fault[0] >= SHADING_CARD_GATE or fault[1] > SHADING_CARD_SHARE,
              f"phase 12d ({name}): the card's render under seed 1 passes the gate against the CPU's "
              f"under seed 0: block MAD {fault[0]:.3e}, {fault[1]:.4%} of pixels apart")
        results[name] = dict(shape=f"{img.shape[1]}x{img.shape[0]}", card_s=card_s, cpu_s=cpu_s, mad=mad,
                             differ=differ, fault=fault)
    grad = M.first_gradient_image(1920, 1080, device=DEVICE)
    check(torch.equal(grad.cpu(), M.first_gradient_image(1920, 1080, device="cpu")),
          "phase 12d: first_gradient_image on the card differs from the CPU's")
    return results


# ---------------------------------------------------------------------------
# 13. the gallery and the scheduling sweep (scripts/render_artifact.py,
#     scripts/render_gallery.py, utils/manifest.py, utils/png.py,
#     probes/sweep_sched.py)
# ---------------------------------------------------------------------------

GALLERY_SPP, GALLERY_BATCH = 500, 100
# 13e: pixels drawn across the image for the gallery's last batch, kernel
# against the plain version.
GALLERY_LANES = 16384


def phase_gallery(out_dir):
    """13a-13b: the four presets at 500 spp in batches of 100 through
    `render_artifact.render_preset` on the scenes of the TPU's renders, under
    render seeds 0 and 1 (`render_gallery.check_preset`): render_kernel
    launched in every batch; the cpu preset's PNG read back byte-equal and
    within the golden's gates; each preset's seed-0 render within
    TPU_GATE x noise of the TPU's render, and its seed-1 render not. The
    launch counts are set to 0 just before and read just after."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.scripts import render_artifact as ra
    from ray_tracing_in_one_weekend_tpu_torch.scripts import render_gallery as rg
    from ray_tracing_in_one_weekend_tpu_torch.utils.png import read_png

    build.reset_launches()
    cpu = ra.render_preset("cpu", GALLERY_SPP, GALLERY_BATCH, out_dir=str(out_dir), seed=0, device=DEVICE,
                           jax_scene=True)
    check(np.array_equal(read_png(cpu.path), cpu.u8), "phase 13a: the PNG read back is not the quantized image")
    checks = {"cpu": rg.check_preset("cpu", out_dir=str(out_dir), device=DEVICE, seed0=cpu)}
    for preset in rg.GALLERY_PRESETS[1:]:
        checks[preset] = rg.check_preset(preset, GALLERY_SPP, str(out_dir), DEVICE)
    for preset, c in checks.items():
        for art in (c.seed0, c.seed1):
            label = f"phase 13 ({art.name})"
            check(art.entry["spp"] == GALLERY_SPP and len(art.batch_s) == GALLERY_SPP // GALLERY_BATCH,
                  f"{label}: {art.entry['spp']} spp in {len(art.batch_s)} batches")
            check(min(art.launches) >= 1, f"{label}: render_kernel launches a batch {art.launches}, "
                                          f"one or more each required")
            check(bool(torch.isfinite(art.image).all()), f"{label}: non-finite pixels")
        check(c.tpu_path is not None, f"phase 13b ({preset}): no TPU render of the preset in gallery/")
        check(not c.failures, f"phase 13 ({preset}): " + "; ".join(c.failures))
    check(checks["cpu"].vs_golden is not None, "phase 13a: the cpu preset was not held against the golden")
    return checks, build.LAUNCHES["render_kernel"]


def phase_manifest(out_dir, checks, smi):
    """13c: the manifest beside the renders holds one entry a render, each
    with this checkout's sources digest, a git commit and the card; the
    digest moves when one byte of a copied render_device.cuh does, and not
    when only a docstring of a copied cuda_render.py does."""
    from ray_tracing_in_one_weekend_tpu_torch.utils import manifest

    m = manifest.load(str(out_dir))
    names = sorted(a.name for c in checks.values() for a in (c.seed0, c.seed1))
    check(sorted(m) == names, f"phase 13c: manifest entries {sorted(m)}, the renders {names}")
    digest = manifest.render_sources_digest()
    for name, e in m.items():
        check(e["render_sources_digest"] == digest, f"phase 13c ({name}): digest {e['render_sources_digest']}")
        check(bool(e["git_commit"]), f"phase 13c ({name}): no git commit")
        check(e["card"] == smi and e["backend"] == "cuda", f"phase 13c ({name}): card {e['card']!r}, "
                                                          f"backend {e['backend']}")
    with tempfile.TemporaryDirectory() as tmp:
        for rel in manifest.RENDER_SOURCES:
            (Path(tmp) / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(REPO / rel, Path(tmp) / rel)
        check(manifest.render_sources_digest(tmp) == digest, "phase 13c: the copied sources' digest differs")
        cuh = Path(tmp) / PKG / "csrc" / "render_device.cuh"
        data = bytearray(cuh.read_bytes())
        data[len(data) // 2] ^= 1
        cuh.write_bytes(bytes(data))
        check(manifest.render_sources_digest(tmp) != digest, "phase 13c: a byte of render_device.cuh changed "
                                                             "and the digest did not")
        shutil.copy(REPO / PKG / "csrc" / "render_device.cuh", cuh)
        py = Path(tmp) / PKG / "ops" / "cuda_render.py"
        src = py.read_text()
        check(src.count('"""The forward render:') == 1, "phase 13c: cuda_render.py's docstring moved")
        py.write_text(src.replace('"""The forward render:', '"""The render forward:'))
        check(manifest.render_sources_digest(tmp) == digest, "phase 13c: a docstring changed the digest")
    return {"entries": len(m), "digest": digest, "git_commit": sorted({e["git_commit"] for e in m.values()})}


def phase_gallery_kernel_vs_plain(presets=("cpu", "gpu")):
    """13e: render_kernel against `_render_pass_plain` at the gallery's
    shapes: its last batch (GALLERY_BATCH samples at sample_offset
    GALLERY_SPP - GALLERY_BATCH) on GALLERY_LANES pixels drawn across the
    image, scheduled as the main path schedules it, bit for bit. The cpu
    preset runs the reference's scene and the aperture lens, the gpu
    preset the JAX package's cover_scene(0) and the defocus angle."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.scripts import render_artifact as ra
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import PRESETS, make_camera_from_config

    results = {}
    for preset in presets:
        config = PRESETS[preset]
        scene, _ = ra.preset_scene(preset, config, DEVICE, jax_scene=True)
        cam = make_camera_from_config(config, DEVICE)
        results[preset] = drawn_lanes_kernel_vs_plain(
            cr.pack_scene(scene), cr.pack_camera(cam), (0, 0, GALLERY_SPP - GALLERY_BATCH, 0), cam.num_pixels,
            GALLERY_BATCH, cam.max_depth, GALLERY_LANES, f"phase 13e ({preset})")
    return results


def phase_sweep():
    """13d: `probes/sweep_sched.py`'s default grid at the bench preset, cold,
    1 untimed and 3 timed renders a configuration; every image equal to the
    default schedule's (the sweep raises otherwise). The launch counts are
    set to 0 just before and read just after."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_sched
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, DEVICE), make_camera_from_config(config, DEVICE)
    build.reset_launches()
    results = sweep_sched.sweep(scene, cam)
    for r in results:
        check(r.launches == r.passes, f"phase 13d: {r.line()}: not one launch a pass")
    return results, build.LAUNCHES["render_kernel"]


# ---------------------------------------------------------------------------
# 14. the differentiable render under torch.autograd (ops/integrator.py,
#     ops/render.py, parallel.dist.render_grads)
# ---------------------------------------------------------------------------

# 14a-c's gate on the loss against the kernels', relative: the image is
# the same bits, so the loss is too; the gate allows float32 summation
# order (tests/test_pallas_grad.py:171-181).
AUTOGRAD_LOSS_GATE = 1e-6


def leaf_params(scene):
    """The scene's differentiable fields as fresh leaves that require grad."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    return {k: v.detach().requires_grad_() for k, v in cg.scene_params(scene).items()}


def check_no_launch(label):
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    check(not launched, f"{label}: the autograd path launched kernels {launched}")


def check_grads(label, grads, want, fields=None):
    """Per field (`fields`, default all), the relative L2 of `grads`
    against `want` (dicts of fields), each within GRAD_GATE."""
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    errs = {k: rel_l2(grads[k], want[k]) for k in (cg.DIFF_FIELDS if fields is None else fields)}
    for k, e in errs.items():
        check(e <= GRAD_GATE, f"{label}: {k} gradient, autograd vs kernels rel L2 {e:.2e} > {GRAD_GATE}")
    return errs


# Phase 14c's ior field. On the JAX cover_scene(0) it is the glass hero's
# (99.9% of it), a sum of 1.25 M events of both signs whose magnitudes add
# to 7.37 times the total, and the autograd step's float32 total sits
# 2.57e-4 (rel L2) from the kernels', above GRAD_GATE (PERF.md §6, PR 14).
# As phase 11b holds a mesh's gradient, 14c holds that field to the exact
# float64 sum of the kernels' events (`probes/shard_error.exact_grads`): the
# kernels within GRAD_GATE of it, the autograd step within
# EXACT_GRAD_FACTOR times the larger of GRAD_GATE and the kernels' own
# distance. Every other field keeps GRAD_GATE against the kernels, and 14a
# and 14b keep it on every field.
EXACT_GRAD_FIELDS = ("ior",)
EXACT_GRAD_FACTOR = SHARD_EXACT_FACTOR


def check_exact_grads(label, grads, want, exact):
    """EXACT_GRAD_FIELDS against `exact` (float64 by field) -> {field:
    (the kernels' rel L2 from it, the autograd gradient's, its bound)}."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2

    out = {}
    for k in EXACT_GRAD_FIELDS:
        e_k, e_a = rel_l2(want[k], exact[k]), rel_l2(grads[k], exact[k])
        most = EXACT_GRAD_FACTOR * max(GRAD_GATE, e_k)
        check(e_k <= GRAD_GATE, f"{label}: {k} gradient, kernels vs the exact sum rel L2 {e_k:.2e} > {GRAD_GATE}")
        check(e_a <= most, f"{label}: {k} gradient, autograd vs the exact sum rel L2 {e_a:.2e} > {most:.2e}")
        out[k] = (e_k, e_a, most)
    return out


def check_loss(label, loss, want):
    err = abs(float(loss) - float(want)) / float(want)
    check(err <= AUTOGRAD_LOSS_GATE, f"{label}: loss {float(loss)!r} vs the kernels' {float(want)!r}")
    return err


def phase_autograd_small(scene, cam):
    """14a: the value and the gradient at 64x32 against the kernels'."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    target = torch.zeros(cam.image_height, cam.image_width, 3, device=DEVICE)
    want = cr.render_cuda(scene, cam)
    loss_k, grads_k = cg.render_grads_cuda(cg.scene_params(scene), scene, cam, target)
    torch_sync()
    build.reset_launches()
    img = rr.render(cg.scene_with_params(scene, leaf_params(scene)), cam, differentiable=True)
    check(img.grad_fn is not None, "phase 14a: render(differentiable=True) recorded no tape")
    loss, grads = pdist.render_grads_pcg(cg.scene_params(scene), scene, cam, target)
    torch_sync()
    check_no_launch("phase 14a")
    check(torch.equal(img.detach(), want), "phase 14a: render(differentiable=True) differs from render_cuda")
    return check_loss("phase 14a", loss, loss_k), check_grads("phase 14a", grads, grads_k)


def phase_autograd_subset(scene, cam, n_lanes=16384):
    """14b: at the bench preset on phase 7b's drawn pixels and cotangent:
    `render_pixels` against `render_cuda` bit for bit, and the autograd
    gradient against `build.grad_pass` on the same lanes."""
    import numpy as np
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent

    spp, depth, n = cam.samples_per_pixel, cam.max_depth, cam.num_pixels
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    img, work = cr.render_cuda(scene, cam, return_work=True)
    work = work.reshape(-1)
    pix = torch.from_numpy(np.random.default_rng(0).choice(n, size=n_lanes, replace=False)).to(DEVICE)
    pix = pix[cr._cost_perm(work[pix])].to(torch.int32)
    g = random_cotangent((3, n_lanes), 2, DEVICE) / spp
    pk = build.grad_pass(p_mat.T.contiguous(), cam_vec, (0, 0, 0, n), pix, g, work, cg.DEFAULT_BWD_TILE,
                         spp, depth)
    torch_sync()
    build.reset_launches()
    t0 = time.perf_counter()
    leaves = leaf_params(scene)
    colors = rr.render_pixels(cg.scene_with_params(scene, leaves), cam, pix, differentiable=True)
    grads = dict(zip(leaves, torch.autograd.grad(colors, list(leaves.values()),
                                                 grad_outputs=(g * spp).T.contiguous())))
    torch_sync()
    seconds = time.perf_counter() - t0
    check_no_launch("phase 14b")
    check(torch.equal(colors.detach(), img.reshape(-1, 3)[pix.long()]),
          "phase 14b: render_pixels differs from render_cuda on the drawn pixels")
    return check_grads("phase 14b", grads, cg.params_vjp(scene, pk)), seconds


def phase_autograd_step(scene, cam):
    """14c: `parallel.dist.render_grads_pcg` once at the bench preset, zero
    target, default chunk: seconds, peak memory, and its loss and gradients
    against `render_grads_cuda`'s; then the forward alone (`render`, no
    tape), timed and held to `render_cuda` bit for bit at full width."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist
    from ray_tracing_in_one_weekend_tpu_torch.probes import rel_l2
    from ray_tracing_in_one_weekend_tpu_torch.probes.shard_error import exact_grads

    target = torch.zeros(cam.image_height, cam.image_width, 3, device=DEVICE)
    loss_k, grads_k = cg.render_grads_cuda(cg.scene_params(scene), scene, cam, target)
    exact = exact_grads(scene, cam, target)
    want = cr.render_cuda(scene, cam)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch_sync()
    build.reset_launches()
    t0 = time.perf_counter()
    loss, grads = pdist.render_grads_pcg(cg.scene_params(scene), scene, cam, target)
    torch_sync()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    img = rr.render(scene, cam)
    torch_sync()
    forward_s = time.perf_counter() - t0
    check_no_launch("phase 14c")
    check(torch.equal(img, want), "phase 14c: the autograd render's forward differs from render_cuda")
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"phase 14c: non-finite {k} gradient")
    errs = check_grads("phase 14c", grads, grads_k, [k for k in cg.DIFF_FIELDS if k not in EXACT_GRAD_FIELDS])
    errs.update({k: rel_l2(grads[k], grads_k[k]) for k in EXACT_GRAD_FIELDS})
    return dict(seconds=seconds, mrays=cam.num_pixels * cam.samples_per_pixel / seconds / 1e6,
                peak_gb=peak_gb, chunk=rr.DEFAULT_CHUNK, forward_s=forward_s,
                loss_err=check_loss("phase 14c", loss, loss_k), errs=errs,
                exact=check_exact_grads("phase 14c", grads, grads_k, exact))


def phase_autograd_demo():
    """14d: the inverse-render example's PCG route with `--grad autograd`
    (`--backend pallas`) on the card."""
    from ray_tracing_in_one_weekend_tpu_torch.examples import inverse_render

    demo_dir = REPO / "build" / "inverse_render_autograd"
    t0 = time.perf_counter()
    rc = inverse_render.main(["--device", DEVICE, "--backend", "pallas", "--grad", "autograd", "--outdir",
                              str(demo_dir)])
    check(rc == 0, f"phase 14d: inverse_render --backend pallas --grad autograd exited {rc}")
    check((demo_dir / "inverse_recovered.ppm").read_bytes().startswith(b"P3\n64 32\n255\n"),
          "phase 14d: bad recovered PPM")
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# 15. the jnp backend on threefry keys (ops/threefry.py, ops/cuda_threefry.py,
#     csrc/threefry_render_kernel.cu)
# ---------------------------------------------------------------------------

# 15c: bench pixels drawn across the image, kernel against the plain version.
JNP_LANES = 16384
# Float32 operations of one sphere test of the keyed sweep, a fused
# multiply-add counting two, as the 67 TFLOP/s peak does: d.c 5, (-2o).c 5,
# half_b 1, c 2, a c 1, disc 2 (csrc/threefry_render_kernel.cu; the ray's
# -2o is taken once). The formula as written (the plain version's) takes c
# in 3, a multiply by 2 a test: its share is printed beside.
JNP_OPS_PER_SPHERE_TEST = 16
JNP_OPS_PER_SPHERE_TEST_UNSCALED = 17
JNP_GALLERY = "cover_1200x800_500spp_jnp.png"


def phase_jnp_scene():
    """15a: cover_scene(0) equals the committed table of the JAX scene, and
    the bench preset's scene is it: 485 active spheres, 396 / 72 / 17."""
    import numpy as np

    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu_torch.scripts import render_artifact as ra
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import PRESETS, make_scene_from_config

    ours = scene_lib.cover_scene(0, device=DEVICE)
    with np.load(ra.JAX_COVER_SCENE_0) as z:
        for f in z.files:
            check(np.array_equal(getattr(ours, f).cpu().numpy(), z[f]),
                  f"phase 15a: cover_scene(0).{f} is not the JAX scene's")
    bench = make_scene_from_config(PRESETS["bench"], DEVICE)
    mix = np.bincount(bench.mat_type[bench.active].cpu().numpy(), minlength=3).tolist()
    check(bench.num_active == 485 and mix == [396, 72, 17],
          f"phase 15a: the bench scene has {bench.num_active} active spheres, mix {mix}")
    return bench.num_active, mix


def phase_jnp_cli():
    """15b: the main path, `--preset bench --backend jnp` through the CLI:
    threefry_render_kernel launched, render_kernel not; the first render
    (first use included) and the timed second one."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.utils import cli

    out = REPO / "build" / "smoke_jnp.ppm"
    build.reset_launches()
    run = cli.run(["--preset", "bench", "--backend", "jnp", "--out", str(out)])
    launches = dict(build.LAUNCHES)
    check(run.backend == "jnp", f"phase 15b: CLI ran backend {run.backend}")
    check(launches["threefry_render_kernel"] > 0, "phase 15b: the CLI never launched threefry_render_kernel")
    check(launches["render_kernel"] == 0, "phase 15b: --backend jnp launched the PCG render kernel")
    check(out.read_bytes().startswith(b"P3\n1200 800\n255\n"), "phase 15b: bad PPM header")
    check(bool(torch.isfinite(run.image).all()) and run.image.shape == (800, 1200, 3),
          "phase 15b: bad image")
    return run, launches["threefry_render_kernel"]


def phase_jnp_kernel_vs_plain(n_lanes=JNP_LANES):
    """15c-d: the kernel against `render_flat_threefry` on `n_lanes` pixels
    drawn across the bench image (10 spp, depth 50): at most 2% of pixels
    flipped and block means agreeing (phase 3's gate), then bit-identical
    (the -fmad=false build and the plain version's exact fused
    multiply-adds), with the same work map. The edge cases against the
    plain version too: fewer pixels than one block, one pixel, one sample,
    a sample window at offset 5. Then the kernel at the main path's shapes,
    every pixel of the bench preset, in identity, reversed and random
    order: after un-permuting, the same bits and the same work map (the
    queue hands pixels to threads in another order each run). Its time by
    CUDA events, its bound from the sweeps it counted, and the time of the
    image twice over in one launch: the queue's ramp and tail are in both
    once, so 2 x one - two is what they cost."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as pr
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.utils import compare
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, DEVICE), make_camera_from_config(config, DEVICE)
    gen = torch.Generator().manual_seed(15)
    pix = torch.randperm(cam.num_pixels, generator=gen)[:n_lanes].to(DEVICE)
    kernel, kernel_work = ct.render_kernel_pixels(scene, cam, pix, 0, return_work=True)
    torch_sync()
    t0 = time.perf_counter()
    plain, plain_work = pr.render_flat_threefry(scene, cam, pix, 0, return_work=True)
    torch_sync()
    plain_s = time.perf_counter() - t0
    side = int(n_lanes ** 0.5)
    agree = compare.images(kernel.reshape(side, side, 3), plain.reshape(side, side, 3), block=8, atol=1e-4)
    check(agree.flipped_frac <= 0.02 and agree.blocks_agree, f"phase 15c: kernel vs plain: {agree}")
    check(torch.equal(kernel, plain), f"phase 15c: kernel vs plain not bit-identical: {agree}")
    check(torch.equal(kernel_work, plain_work), "phase 15c: the kernel's work map is not the plain version's")
    edges = {"77 pixels (under one block)": dict(n=77), "1 pixel": dict(n=1), "spp 1": dict(n=500, spp=1),
             "samples 5-7": dict(n=300, spp=3, sample_offset=5)}
    for label, kw in edges.items():
        sub = pix[: kw.pop("n")]
        got = ct.render_kernel_pixels(scene, cam, sub, 0, return_work=True, **kw)
        want = pr.render_flat_threefry(scene, cam, sub, 0, return_work=True, **kw)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"phase 15c: kernel vs plain differ on {label}")

    full = torch.arange(cam.num_pixels, device=DEVICE)
    image, work = ct.render_kernel_pixels(scene, cam, full, 0, return_work=True)
    orders = {"reversed": full.flip(0), "random": torch.randperm(cam.num_pixels, generator=gen).to(DEVICE)}
    for label, order in orders.items():
        got, got_work = ct.render_kernel_pixels(scene, cam, order, 0, return_work=True)
        back = torch.empty_like(order)
        back[order] = torch.arange(order.numel(), device=DEVICE)
        check(torch.equal(got[back], image) and torch.equal(got_work[back], work),
              f"phase 15c: the bench image in {label} order is not the identity order's bits and work map")
    twice = torch.cat([full, full])
    ms = cuda_ms(lambda: ct.render_kernel_pixels(scene, cam, full, 0), reps=5)
    ms_twice = cuda_ms(lambda: ct.render_kernel_pixels(scene, cam, twice, 0), reps=3)
    sweeps = float(work.double().sum())
    n_bytes = 4.0 * (16 * scene.num_slots + 24 + full.numel() * (1 + 3))
    bound = kp.bound_ms(sweeps * scene.num_active * JNP_OPS_PER_SPHERE_TEST, n_bytes)
    bound_17 = kp.bound_ms(sweeps * scene.num_active * JNP_OPS_PER_SPHERE_TEST_UNSCALED, n_bytes)
    grid = build.threefry_grid(scene.num_slots, cam.num_pixels)
    threads = grid * 128
    return {"agree": agree, "plain_s": plain_s, "ms": ms, "ms_twice": ms_twice, "tail_ms": 2 * ms - ms_twice,
            "sweeps": sweeps, "bound": bound, "bound_17": bound_17, "grid": grid,
            "max_pixel_sweeps": int(work.max()), "mean_pixel_sweeps": sweeps / cam.num_pixels,
            "sweeps_per_thread": sweeps / threads, "n_pixels": cam.num_pixels, "spp": cam.samples_per_pixel,
            "mrays": cam.num_pixels * cam.samples_per_pixel / ms / 1e3}


def phase_jnp_gallery():
    """15e: the gallery's jnp image at full size (preset cpu: 1200x800,
    aperture 0.1, the reference's scene, 500 spp in batches of 100, depth
    50) through `accumulate(backend="jnp")` under render seeds 0 and 1,
    against the TPU's `gallery/cover_1200x800_500spp_jnp.png` (read by
    `read_png`): phase 13b's criterion, MAD(seed 0, TPU) below TPU_GATE x
    MAD(seed 0, seed 1), MAD(seed 1, TPU) not."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu_torch.scripts import render_gallery as rg
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import PRESETS, make_camera_from_config
    from ray_tracing_in_one_weekend_tpu_torch.utils.png import read_png

    tpu = read_png(str(REPO / "gallery" / JNP_GALLERY))
    scene = scene_lib.cover_scene_reference(device=DEVICE)
    cam = make_camera_from_config(PRESETS["cpu"], DEVICE)
    images, seconds, launches = {}, {}, {}
    for seed in (0, 1):
        build.reset_launches()
        torch_sync()
        t0 = time.perf_counter()
        state = ckpt.new_state(cam, DEVICE)
        while state.spp_done < GALLERY_SPP:
            state = ckpt.accumulate(state, scene, cam, seed, GALLERY_BATCH, backend="jnp")
        torch_sync()
        seconds[seed] = time.perf_counter() - t0
        launches[seed] = build.LAUNCHES["threefry_render_kernel"]
        check(launches[seed] == GALLERY_SPP // GALLERY_BATCH,
              f"phase 15e: {launches[seed]} kernel launches for {GALLERY_SPP // GALLERY_BATCH} batches")
        check(bool(torch.isfinite(state.image).all()), f"phase 15e: non-finite pixels (seed {seed})")
        images[seed] = to_uint8(state.image).cpu().numpy()
    noise = rg.image_stats(images[0], images[1]).mad
    vs_tpu, seed1_vs_tpu = rg.image_stats(images[0], tpu), rg.image_stats(images[1], tpu)
    check(vs_tpu.mad < rg.TPU_GATE * noise,
          f"phase 15e: seed 0 vs the TPU's jnp image MAD {vs_tpu.mad:.4f} >= {rg.TPU_GATE} x noise {noise:.4f}")
    check(not seed1_vs_tpu.mad < rg.TPU_GATE * noise,
          f"phase 15e: seed 1 vs the TPU's jnp image MAD {seed1_vs_tpu.mad:.4f} < {rg.TPU_GATE} x noise")
    rays = cam.num_pixels * GALLERY_SPP
    return {"vs_tpu": vs_tpu, "seed1_vs_tpu": seed1_vs_tpu, "noise": noise, "seconds": seconds,
            "mrays": {s: rays / t / 1e6 for s, t in seconds.items()}, "launches": launches}


# ---------------------------------------------------------------------------
# 16. the keyed gradient (parallel/dist.py render_grads, ops/cuda_threefry.py,
#     csrc/threefry_grad_kernel.cu)
# ---------------------------------------------------------------------------

# The keyed train step's kernels, by their launch counts: the recording
# forward, the reverse walk and the reduction.
KEYED_KERNELS = ("threefry_record", "threefry_reverse", "grad_reduce")
# Pixels a chunk of the autograd oracle's backward in 16c: a quarter of the
# bench image. At one chunk its float32 sums of the per-bounce gathers sit
# 4.9e-4 (center) and 2.7e-4 (albedo) off the exact sum of the kernels'
# events, at four 6.1e-5 and 6.8e-5, as far as the plain reverse's own
# events summed exactly (6.2e-5; probes/keyed_grad_exact.py, H100 80GB HBM3,
# 700 W), for 184 s and 16.3 GB against 83 s and 46.9 GB.
KEYED_ORACLE_CHUNK = 240000
KEYED_REPLACES = ("ray_tracing_in_one_weekend_tpu/parallel/dist.py:244 render_grads -> ops/integrator.py:50 "
                  "trace_rays (no Pallas kernel: the jnp path under jax.grad)")


def example_world():
    """The inverse-render example's scene, camera (64x32, spp 4, depth 8),
    target (the true scene's keyed image) and damaged albedos."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    scene = scene_lib.three_sphere_scene(pad_to=128, device=DEVICE)
    cam = make_camera(image_width=64, aspect_ratio=2.0, samples_per_pixel=4, max_depth=8, vfov_degrees=90.0,
                      lookfrom=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, -1.0), defocus_angle_degrees=0.0,
                      focus_dist=1.5, device=DEVICE)
    params = pdist.scene_params(scene)
    damaged = params["albedo"].clone()
    damaged[1] = torch.tensor([0.6, 0.6, 0.6], device=DEVICE)
    damaged[3] = torch.tensor([0.3, 0.3, 0.8], device=DEVICE)
    return scene, cam, dict(params, albedo=damaged), rr.render_image(scene, cam, 0)


def phase_keyed_small():
    """16a: `parallel.dist.render_grads` through the kernels at 64x32 on the
    example's world (its damaged albedos and target) and on cover_scene(0)
    (spp 2, zero target): the recording forward's image and work map the
    bits of `threefry_render_kernel`'s, the three kernels launched once (a
    re-run of the recording forward counted apart, at most one), the loss
    the bits of the loss of `threefry_render_kernel`'s image, and each
    field within GRAD_GATE of `render_grads_autograd` on the card (which
    launches nothing)."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist
    from ray_tracing_in_one_weekend_tpu_torch.probes import small_camera

    scene, cam, params, target = example_world()
    cover = scene_lib.cover_scene(0, device=DEVICE)
    cam2 = small_camera(DEVICE, spp=2)
    worlds = {"example": (scene, cam, params, target),
              "cover": (cover, cam2, pdist.scene_params(cover),
                        torch.zeros(cam2.image_height, cam2.image_width, 3, device=DEVICE))}
    out = {}
    for label, (sc, c, p, t) in worlds.items():
        pix = torch.arange(c.num_pixels, device=DEVICE)
        img, work, _ = ct.record_keyed(sc, c, pix, 0)
        img_f, work_f = ct.render_kernel_pixels(sc, c, pix, 0, return_work=True)
        check(torch.equal(img, img_f) and torch.equal(work, work_f),
              f"phase 16a ({label}): the recording forward's image or work map is not threefry_render_kernel's")
        build.reset_launches()
        loss, grads = pdist.render_grads(p, sc, c, t, 0)
        torch_sync()
        reruns = build.LAUNCHES["threefry_record_rerun"]
        check(reruns <= 1, f"phase 16a ({label}): the recording forward re-ran {reruns} times")
        for k in KEYED_KERNELS:
            want = 1 + (reruns if k == "threefry_record" else 0)
            check(build.LAUNCHES[k] == want, f"phase 16a ({label}): {k} launched {build.LAUNCHES[k]} times, not {want}")
        img = rr.render_image(pdist.scene_with_params(sc, p), c, 0)
        check(torch.equal(loss, torch.mean((img - t) ** 2)),
              f"phase 16a ({label}): the kernels' loss is not the loss of threefry_render_kernel's image")
        build.reset_launches()
        loss_a, grads_a = pdist.render_grads_autograd(p, sc, c, t, 0)
        torch_sync()
        check_no_launch(f"phase 16a ({label})")
        check(torch.equal(loss_a, loss), f"phase 16a ({label}): the autograd oracle's loss differs")
        out[label] = check_grads(f"phase 16a ({label})", grads, grads_a)
    return out


def phase_keyed_subset(n_lanes=JNP_LANES):
    """16b: at the bench preset on phase 15c's drawn pixels: the recording
    forward's image and work map `threefry_render_kernel`'s bits and the
    plain recording's (`record_plain`, timed), its records in logical
    order (`records_in_logical_order`: the links and `build.path_slots`)
    bit-identical to `replay_records_plain`'s words 0-13, the reverse's
    events within ADJOINT_GATE of `reverse_records_plain`'s on the plain
    replay (winners equal; the error also read by distance from the
    path's end) and the plain per-path reverse on the kernel's arena
    (`reverse_paths_plain`) the plain reverse's bits, the reduction the
    ordered plain reduction's bits, and the backward's [16, N] cotangent
    bit-identical run to run, for the pixels in another order and through
    a forced overflow (an arena of 1024 records: `threefry_grad_pass`
    records again once)."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.probes import random_cotangent, rel_l2
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, DEVICE), make_camera_from_config(config, DEVICE)
    n, spp, depth = cam.num_pixels, cam.samples_per_pixel, cam.max_depth
    gen = torch.Generator().manual_seed(15)  # phase 15c's draw
    pix = torch.randperm(n, generator=gen)[:n_lanes].to(DEVICE)
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam)
    table, pix32, key = p_mat.T.contiguous(), pix.to(torch.int32), (0, 0)
    args = (table, cam_vec, pix32, key, 0, spp, depth)
    img, work, rec = build.threefry_record(*args)
    img_f, work_f = build.threefry_render(*args, work=True)
    check(torch.equal(img, img_f) and torch.equal(work, work_f),
          "phase 16b: the recording forward's image or work map is not threefry_render_kernel's")
    rec = build.complete_recording(rec, int(rec.total))
    total, sweeps = int(rec.total), int(work.sum())
    out = {"n_records": sweeps}
    torch_sync()
    t0 = time.perf_counter()
    img_p, work_p, rec_p = ct.record_plain(scene, cam, pix, 0)
    torch_sync()
    out["record_plain_ms"] = (time.perf_counter() - t0) * 1e3
    check(torch.equal(img, img_p) and torch.equal(work, work_p) and torch.equal(rec.path_count, rec_p.path_count),
          "phase 16b: the recording forward's image, work map or path counts differ from the plain recording's")
    slots, n_events = build.path_slots(pix32, rec.path_count, spp, 0, n)
    n_events = int(n_events)
    check(n_events == sweeps, f"phase 16b: {n_events} event slots for {sweeps} sweeps")
    logical = ct.records_in_logical_order(rec, slots, n_events)
    plain = ct.replay_records_plain(scene, cam, pix, 0)
    out["record_abs_err"] = float((logical[:, :9] - plain.records[:, :9]).abs().max())
    same = logical.view(torch.int32)[:, :14] == plain.records.view(torch.int32)[:, :14]
    check(bool(same.all()), f"phase 16b: {int((~same.all(1)).sum())} of {same.shape[0]} records in logical order "
                            "differ from the plain replay's in words 0-13 (bit-identical required)")
    del logical, same
    g = random_cotangent((3, n_lanes), 2, DEVICE) / spp
    t0 = time.perf_counter()
    want = ct.reverse_records_plain(p_mat, cam_vec, plain, g)
    torch_sync()
    out["reverse_plain_ms"] = (time.perf_counter() - t0) * 1e3
    per_path = ct.reverse_paths_plain(p_mat, cam_vec, rec, slots, n_events, g)
    check(torch.equal(per_path.view(torch.int32), want.view(torch.int32)),
          "phase 16b: the plain per-path reverse on the kernel's arena is not the plain reverse's bits")
    del per_path
    events = build.threefry_reverse(rec, slots, n_events, g, total)
    wk, wp = events[:, 0].view(torch.int32), want[:, 0].view(torch.int32)
    check(torch.equal(wk, wp), f"phase 16b: {int((wk != wp).sum())} event winners differ from the plain reverse's")
    out["event_err"] = rel_l2(events[:, 1:14], want[:, 1:14])
    out["event_abs_err"] = float((events[:, 1:14] - want[:, 1:14]).abs().max())
    check(out["event_err"] <= ADJOINT_GATE,
          f"phase 16b: reverse kernel vs plain events rel L2 {out['event_err']:.2e} > {ADJOINT_GATE}")
    back = cg._path_positions(plain.records)[2].clamp(max=8)
    out["event_err_by_back"] = {}
    for b in range(1, 9):
        sel = ((back == b) & (wk >= 0)).nonzero()[:, 0]
        if sel.numel():
            out["event_err_by_back"]["8+" if b == 8 else str(b)] = rel_l2(events[sel, 1:14], want[sel, 1:14])
    check_reduce_bits(events, p_mat.shape[1], "phase 16b")
    pk = build.threefry_grad_pass(rec, g, 0, n)
    check(torch.equal(pk, build.threefry_grad_pass(rec, g, 0, n)), "phase 16b: two kernel runs differ")
    perm = torch.randperm(n_lanes, generator=gen).to(DEVICE)
    _, _, rec_perm = build.threefry_record(table, cam_vec, pix32[perm].contiguous(), key, 0, spp, depth)
    check(torch.equal(pk, build.threefry_grad_pass(rec_perm, g[:, perm].contiguous(), 0, n)),
          "phase 16b: the gradient changed with the pixels' order")
    _, _, small = build.threefry_record(*args, capacity=1024)
    reruns = build.LAUNCHES["threefry_record_rerun"]
    check(torch.equal(pk, build.threefry_grad_pass(small, g, 0, n)),
          "phase 16b: the gradient changed through an arena's overflow")
    out["overflow_reruns"] = build.LAUNCHES["threefry_record_rerun"] - reruns
    check(out["overflow_reruns"] == 1, f"phase 16b: an arena of 1024 records re-ran {out['overflow_reruns']} times")
    out["n_events"] = events.shape[0]
    return out


def keyed_parent_steps(parent, out_dir):
    """The keyed step of the `parent` checkout and of this one, each in a
    fresh process (`probes/keyed_step.py`), in turns: parent, this, this,
    parent -> ({"parent": [...], "this": [...]} of its JSON lines, the
    parent's last gradient)."""
    import subprocess

    import torch

    out_dir.mkdir(parents=True, exist_ok=True)
    script = REPO / PKG / "probes" / "keyed_step.py"
    runs = {"parent": [], "this": []}
    for i, who in enumerate(("parent", "this", "this", "parent")):
        root = Path(parent).resolve() if who == "parent" else REPO
        grads = out_dir / f"keyed_step_{i}_{who}.pt"
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run([sys.executable, str(script), "--out", str(grads), "--profile"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"phase 16c: the {who} checkout's keyed step exited {res.returncode}: "
                                   f"{res.stderr[-2000:]}")
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
        if who == "parent":
            parent_grads = torch.load(grads)
    return runs, parent_grads


def phase_keyed_step(scene, cam, parent=None, warm_reps=3):
    """16c: the slice at full width, `parallel.dist.render_grads` at the bench
    preset with a zero target: a cold step then warm steps (seconds, launch
    counts, re-runs of the recording forward, the step's own peak memory),
    two warm steps under torch.profiler (each kernel's device ms, no
    replay kernel, the idle share of what it traced and the launches it
    missed), each kernel's bound from this step's
    sweeps and paths, the recording forward's bench image the bits of
    `threefry_render_kernel`'s; with `parent`, the parent checkout's warm
    step beside this one's in fresh processes and its gradient held to
    this one's bit for bit; then the gradients once against
    `render_grads_autograd` on the card at KEYED_ORACLE_CHUNK pixels a
    chunk, GRAD_GATE per field but EXACT_GRAD_FIELDS, held as phase 14c
    holds them to the exact float64 sum of the kernels' events
    (`probes/keyed_grad_exact.keyed_exact_grads`)."""
    import torch
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
    from ray_tracing_in_one_weekend_tpu_torch.ops.integrator import _END_SKY, _REC_END
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms, rel_l2
    from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
    from ray_tracing_in_one_weekend_tpu_torch.probes.keyed_grad_exact import keyed_exact_grads, keyed_step_paths
    from ray_tracing_in_one_weekend_tpu_torch.probes.keyed_step import profiled_steps

    params = pdist.scene_params(scene)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=DEVICE)
    rays = cam.num_pixels * cam.samples_per_pixel
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch_sync()
    live = torch.cuda.memory_allocated()  # what earlier phases still hold
    build.reset_launches()
    t0 = time.perf_counter()
    loss, grads = pdist.render_grads(params, scene, cam, target, 0)
    torch_sync()
    cold_s = time.perf_counter() - t0
    cold_reruns = build.LAUNCHES["threefry_record_rerun"]
    warm = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        loss, grads = pdist.render_grads(params, scene, cam, target, 0)
        torch_sync()
        warm.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_gb = (torch.cuda.max_memory_allocated() - live) / 1e9
    check(bool(torch.isfinite(loss)) and float(loss) > 0.0, "phase 16c: bad loss")
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"phase 16c: non-finite {k} gradient")
    check(cold_reruns <= 1, f"phase 16c: the cold step re-ran the recording forward {cold_reruns} times")
    check(launches["threefry_record_rerun"] == cold_reruns,
          f"phase 16c: warm steps re-ran the recording forward {launches['threefry_record_rerun'] - cold_reruns} times")
    check(launches["threefry_render_kernel"] == 0,
          f"phase 16c: the steps launched threefry_render_kernel {launches['threefry_render_kernel']} times")
    for k in KEYED_KERNELS:
        want = 1 + warm_reps + (cold_reruns if k == "threefry_record" else 0)
        check(launches[k] == want, f"phase 16c: {k} launched {launches[k]} times in {1 + warm_reps} steps, not {want}")
    # Two warm steps under the profiler (`probes/keyed_step.profiled_steps`,
    # as the parent's and this checkout's steps are read with --parent): each
    # kernel's device time a traced launch, and the device's idle share of the
    # steps, 1 - traced busy / wall, beside the hand-written launches traced.
    names = {"record": "threefry_record_kernel", "reverse": "threefry_reverse_kernel",
             "reduce_chunks": "grad_reduce_chunks", "reduce_partials": "grad_reduce_partials"}
    profiled = 2
    prof = profiled_steps(lambda: pdist.render_grads(params, scene, cam, target, 0), build.LAUNCHES, profiled)
    counts = {label: sum(c for k, c in prof["kernel_counts"].items() if key in k) for label, key in names.items()}
    check(all(0 < c <= profiled for c in counts.values()),
          f"phase 16c: the profiler traced {counts} launches in {profiled} steps")
    kernel_ms = {label: sum(t for k, t in prof["kernel_ms"].items() if key in k) / counts[label]
                 for label, key in names.items()}
    replay_launches = sum(c for k, c in prof["kernel_counts"].items() if "replay" in k)
    check(replay_launches == 0, f"phase 16c: {replay_launches} replay kernels ran in the steps")
    wall_ms, busy_ms = prof["wall_ms"], prof["busy_ms"]
    untraced = prof["launches_made"] - prof["launches_traced"]
    # The bounds, from this step's sweeps and paths; the recording forward's
    # image against the forward kernel's.
    img, p_mat, cam_vec, rec, slots, n_events, g = keyed_step_paths(scene, cam, target)
    n, n_slots, paths = cam.num_pixels, p_mat.shape[1], rec.path_count.numel()
    pix = torch.arange(n, device=DEVICE)
    img_f, work_f = ct.render_kernel_pixels(scene, cam, pix, 0, return_work=True)
    check(torch.equal(img, img_f), "phase 16c: the recording forward's bench image is not threefry_render_kernel's")
    lit = rec.arena.view(torch.int32)[rec.path_last, _REC_END] == _END_SKY  # the paths that reached the sky
    lit_records = int(rec.path_count[lit].sum())
    dark_paths = int((~lit).sum())
    table_bytes = 4.0 * (16 * n_slots + 24)
    ops = float(n_events) * scene.num_active * JNP_OPS_PER_SPHERE_TEST
    bounds = {
        # pix in; radiance and work out; a record a sweep; each path's count and last slot
        "record": kp.bound_ms(ops, table_bytes + n * (4.0 + 12.0 + 4.0) + 64.0 * n_events + 12.0 * paths),
        "forward": kp.bound_ms(ops, table_bytes + 4.0 * n * (1 + 3 + 1)),
        # g in; each path's slot, count and last slot; a lit path's records whole, a dark path's end
        # word's sector; an event a sweep out
        "reverse": kp.bound_ms(0.0, table_bytes + 12.0 * n + 20.0 * paths + 64.0 * lit_records
                               + 32.0 * dark_paths + 64.0 * n_events),
    }
    total = int(rec.total)
    record_alone_ms = cuda_ms(lambda: ct.record_keyed(scene, cam, pix, 0), reps=3)
    forward_ms = cuda_ms(lambda: ct.render_kernel_pixels(scene, cam, pix, 0, return_work=True), reps=3)
    reverse_alone_ms = cuda_ms(lambda: build.threefry_reverse(rec, slots, n_events, g, total), reps=3)
    events = build.threefry_reverse(rec, slots, n_events, g, total)
    del rec, slots, img_f, work_f
    bounds["reduce"] = reduce_bounds(events, n_slots)[0]
    reduce_ms, library_ms = reduce_times(events, n_slots)
    del events
    parent_runs = None
    if parent is not None:
        torch.cuda.empty_cache()
        parent_runs, parent_grads = keyed_parent_steps(parent, REPO / "build" / "keyed_parent")
        for k, v in grads.items():
            check(torch.equal(v.cpu(), parent_grads[k]), f"phase 16c: the {k} gradient is not the parent's bits")
    # The oracle, once.
    exact = keyed_exact_grads(scene, cam, target)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    torch_sync()
    t0 = time.perf_counter()
    loss_a, grads_a = pdist.render_grads_autograd(params, scene, cam, target, 0, chunk_size=KEYED_ORACLE_CHUNK)
    torch_sync()
    oracle_s = time.perf_counter() - t0
    oracle_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_no_launch("phase 16c (render_grads_autograd)")
    check(torch.equal(loss_a, loss), "phase 16c: the autograd oracle's loss is not the kernels' bits")
    errs = check_grads("phase 16c", grads, grads_a, [k for k in pdist.DIFF_FIELDS if k not in EXACT_GRAD_FIELDS])
    errs.update({k: rel_l2(grads[k], grads_a[k]) for k in EXACT_GRAD_FIELDS})
    vs_exact = {k: (rel_l2(grads[k], exact[k]), rel_l2(grads_a[k], exact[k])) for k in pdist.DIFF_FIELDS}
    return dict(cold_s=cold_s, warm_s=warm, mrays=[rays / t / 1e6 for t in warm], cold_mrays=rays / cold_s / 1e6,
                launches=launches, cold_reruns=cold_reruns, peak_gb=peak_gb, step_gb=step_gb, wall_ms=wall_ms,
                busy_ms=busy_ms, idle=prof["idle"], untraced=untraced, kernel_ms=kernel_ms,
                replay_launches=replay_launches,
                record_alone_ms=record_alone_ms, forward_ms=forward_ms, reverse_alone_ms=reverse_alone_ms,
                reduce_ms=reduce_ms, library_ms=library_ms, bounds=bounds, n_events=n_events,
                lit_records=lit_records, dark_paths=dark_paths, parent_runs=parent_runs,
                oracle_s=oracle_s, oracle_peak_gb=oracle_peak_gb, errs=errs, vs_exact=vs_exact,
                exact=check_exact_grads("phase 16c", grads_a, grads, exact))


def phase_keyed_demo():
    """16d: the inverse-render example's default (`--backend jnp`) on the
    card: exit 0, the four keyed kernels launched."""
    from ray_tracing_in_one_weekend_tpu_torch.examples import inverse_render
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    demo_dir = REPO / "build" / "inverse_render_keyed"
    build.reset_launches()
    t0 = time.perf_counter()
    rc = inverse_render.main(["--device", DEVICE, "--outdir", str(demo_dir)])
    seconds = time.perf_counter() - t0
    check(rc == 0, f"phase 16d: inverse_render (--backend jnp) exited {rc}")
    check((demo_dir / "inverse_recovered.ppm").read_bytes().startswith(b"P3\n64 32\n255\n"),
          "phase 16d: bad recovered PPM")
    for k in KEYED_KERNELS:
        check(build.LAUNCHES[k] > 0, f"phase 16d: the example never launched {k}")
    return seconds, dict(build.LAUNCHES)


def phase_keyed_ranks(out_dir):
    """16e: the keyed step in 2 local ranks over gloo on a (2, 1) pixel mesh
    and a (1, 2) sample mesh (cover_scene(0), 64x32, spp 4, depth 8, zero
    target, each twice) against one process: the step's image one
    process's bits on the pixel mesh and the windows' rank-order mean's
    bits within SHARD_IMAGE_ATOL of one render on the sample mesh; the loss
    as phase 11b holds it, the gradients within rtol 2e-5 + atol 1e-6 of
    one process's (phase 11b's gate at 64x32), every rank the same bits run
    to run; the four kernels launched on every rank."""
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist
    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker
    from ray_tracing_in_one_weekend_tpu_torch.probes import small_camera

    scene, cam = scene_lib.cover_scene(0, device=DEVICE), small_camera(DEVICE)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=DEVICE)
    loss_ref, grads_ref = pdist.render_grads(pdist.scene_params(scene), scene, cam, target, 0)
    one = pdist.render_distributed(scene, cam, 0).cpu()
    meshes = ((2, 1), (1, 2))
    t0 = time.perf_counter()
    ranks = worker.launch([dict(job("keyed_step", scene, cam, m, 2), kw={"base_key": 0}) for m in meshes], 2,
                          out_dir / "keyed_ranks2", device=DEVICE, timeout=SHARD_TIMEOUT)
    seconds = time.perf_counter() - t0
    out = {}
    for i, mesh in enumerate(meshes):
        label = f"phase 16e ({mesh[0]}x{mesh[1]})"
        rs = [r[i] for r in ranks]
        check(all(r["backend"] == "gloo" for r in rs), f"{label}: backend {[r['backend'] for r in rs]}")
        img = rs[0]["image"]
        check(all(torch.equal(r["image"], img) for r in rs), f"{label}: the ranks' images differ")
        if mesh[1] == 1:
            check(torch.equal(img, one), f"{label}: the pixel mesh's image is not one process's bits")
            image_err = 0.0
        else:
            pix = torch.arange(cam.num_pixels, device=DEVICE)
            half = cam.samples_per_pixel // 2
            wins = [rr.render_keyed(scene, cam, pix, 0, half, s * half).cpu() for s in range(2)]
            comp = ((wins[0] + wins[1]) / 2).reshape(img.shape)
            check(torch.equal(img, comp), f"{label}: the sample mesh's image is not the rank-order mean's bits")
            image_err = float((img - one).abs().max())
            check(image_err <= SHARD_IMAGE_ATOL, f"{label}: image {image_err:.2e} off one process")
        loss = rs[0]["loss"]
        check(all(torch.equal(r["loss"], loss) for r in rs), f"{label}: the ranks' losses differ")
        check(all(all(r["same"]) for r in rs), f"{label}: a repeated step gave other bits")
        loss_err = abs(float(loss) - float(loss_ref)) / float(loss_ref)
        if mesh[1] == 1:
            check(torch.equal(loss, loss_ref.cpu()), f"{label}: the pixel mesh's loss is not one process's bits")
        check(loss_err <= SHARD_LOSS_RTOL, f"{label}: loss {loss_err:.2e} relative off one process")
        vs_one = {}
        for k, g in grads_ref.items():
            check(all(torch.equal(r["grads"][k], rs[0]["grads"][k]) for r in rs), f"{label}: the ranks' {k} differ")
            vs_one[k] = grad_excess(rs[0]["grads"][k], g)
            check(vs_one[k] <= 1.0, f"{label}: {k} gradient off one process by {vs_one[k]:.3f} of rtol "
                                    f"{SHARD_GRAD_RTOL} + atol {SHARD_GRAD_ATOL}")
        for k in KEYED_KERNELS:
            check(all(r["launches"][k] > 0 for r in rs), f"{label}: a rank never launched {k}")
        out[f"{mesh[0]}x{mesh[1]}"] = dict(image_err=image_err, loss_err=loss_err, vs_one=vs_one,
                                           step_s=[max(r["seconds"][j] for r in rs) for j in range(2)],
                                           launches=[{k: r["launches"][k] for k in KEYED_KERNELS} for r in rs])
    return out, seconds


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of the port: its reduction is timed beside this one's in phase 7c, "
                         "its keyed train step in phase 16c, its chain probe's output in phase 9")
    parent = ap.parse_args(argv).parent

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
    from ray_tracing_in_one_weekend_tpu_torch.probes import reduce_parts

    reduce_blocks = build.blocks_per_sm("grad_reduce_chunks", 256, sweep_readings.N_SLOTS)
    reduce_resources = (f"{reduce_parts.resources_line(res.log)}; grad_reduce_chunks blocks per SM at "
                        f"{sweep_readings.N_SLOTS} spheres {reduce_blocks}")
    say(f"phase 2 reduction: {reduce_resources}")

    keyed_resources = {}
    for name, r in sweep_readings.ptxas_resources(res.log).items():
        for kernel in ("threefry_record_kernel", "threefry_reverse_kernel"):
            if kernel in name:
                keyed_resources[kernel] = {"registers": r.registers, "spill_stores": r.spill_stores,
                                           "spill_loads": r.spill_loads}
    record_blocks = build.blocks_per_sm("threefry_record_kernel", 128, sweep_readings.N_SLOTS)
    keyed_resources["threefry_record_kernel"]["blocks_per_sm_tile128"] = record_blocks
    say("phase 2 keyed train step: " + "; ".join(f"{k} {v['registers']} registers, spill stores/loads "
                                                 f"{v['spill_stores']}/{v['spill_loads']}"
                                                 for k, v in keyed_resources.items())
        + f"; threefry_record_kernel blocks per SM at {sweep_readings.N_SLOTS} spheres {record_blocks}")

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
    # The forward pass's bound: the active spheres' tests over this pass's
    # lane-iterations (the sweep also tests the padding slots, which the
    # function does not need), against its lane state read and written once.
    render_bound = kp.bound_ms(
        float(of_k[cr._SF_WORK].double().sum()) * scene.num_active * kp.OPS_PER_SPHERE_TEST,
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
    step = phase_train_step(scene, cam, parent.resolve() if parent else None)
    parts = step["reduce_parts"]
    med = {label: {k: statistics.median(v) for k, v in t.items()} for label, t in parts.items()}
    mine = med["this tree"]
    stats = step["event_stats"]
    say(f"phase 7c train step (render_grads_cuda, bench preset, zero target): cold "
        f"{step['cold_s']:.4f}s = {step['cold_mrays']:.2f} Mrays/s, {step['cold_segments']} new allocator "
        f"segments (again after the warm steps: "
        f"{step['cold_again_s']:.4f}s); warm (work_hint carry) "
        + ", ".join(f"{t:.4f}s" for t in step["warm_s"]) + " = "
        + ", ".join(f"{r:.2f}" for r in step["mrays"]) + f" Mrays/s; launches {step['launches']}; "
        f"peak memory {step['peak_gb']:.3f} GB; gradients finite on every field; at full width on the "
        f"step's lanes ({step['n_events']} bounces): replay {step['replay_ms']:.3f} ms (bound "
        f"{step['replay_bound'][0]:.3f} by {step['replay_bound'][1]}), reverse {step['reverse_ms']:.3f} ms "
        f"(bound {step['reverse_bound'][0]:.3f} by {step['reverse_bound'][1]}), reduction "
        f"{step['reduce_ms']:.3f} ms (bound {step['reduce_bound'][0]:.3f} by {step['reduce_bound'][1]}), "
        f"index_add_ {step['reduce_library_ms']:.3f} ms [{smi}]")
    say(f"phase 7c reduction at full width: {stats['events']} events in {stats['chunks']} chunks, no sphere "
        f"{stats['no_sphere_share']:.4f}, the most events one sphere takes in a chunk median "
        f"{stats['heaviest_median']:.0f} max {stats['heaviest_max']}; bit-identical to the ordered plain "
        f"reduction; {reduce_resources}; medians of 5 rounds in turns: "
        + "; ".join(f"{label} pair {m['pair']:.4f} ms (chunks {m['chunks']:.4f}, partials {m['partials']:.4f})"
                    for label, m in med.items())
        + f"; bounds {step['reduce_bound'][0]:.4f} ms (the bytes its events need: 32 an event with no "
        f"sphere, 64 the others; pair at {step['reduce_bound'][0] / mine['pair']:.1%}) and "
        f"{step['reduce_bound_whole'][0]:.4f} ms (every event read whole, 64 bytes; pair at "
        f"{step['reduce_bound_whole'][0] / mine['pair']:.1%}) [{smi}]")
    from ray_tracing_in_one_weekend_tpu_torch.examples import inverse_render

    demo_dir = REPO / "build" / "inverse_render"
    rc = inverse_render.main(["--device", DEVICE, "--backend", "pallas", "--outdir", str(demo_dir)])
    check(rc == 0, f"phase 7d: the inverse-render demo exited {rc}")
    check((demo_dir / "inverse_recovered.ppm").read_bytes().startswith(b"P3\n64 32\n255\n"),
          "phase 7d: bad recovered PPM")
    say("phase 7d inverse render (--backend pallas): the demo recovered sphere 1's albedo (error at least halved)")

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
    chain = probes["chain_fma"]["chain"] = phase_chain(res, parent.resolve() if parent else None)
    say("phase 9 probes: kernel vs plain (error, gate) " + ", ".join(
        f"{k} {v['err']:.2e} ({kp.GATES[k]:g})" for k, v in probes.items()))
    say(f"phase 9 {chain['reading'].line()}; at {CHAIN_REMAINDER} steps on [128, 196] and [128, {kp.JAX_TILE}] "
        f"error {chain['remainder_err']:.2e} ({kp.GATES['chain_fma']:g}); sha256 of the {kp.JAX_TILE}-column, "
        f"{kp.CHAIN}-step output {chain['sha256']}"
        + (f", the parent's {chain['parent_sha256']} (equal)" if chain["parent_sha256"] else
           " (no --parent: the parent's not read)"))
    for k, v in probes.items():
        say(f"phase 9 {k}: launches {v['launches']}; {v['timing'].line()}; {v['fill'].line()}; "
            f"plain {v['plain_ms']:.2f} ms at {kp.JAX_TILE} columns [{smi}]")
    say(f"phase 9 perf_probe: warp occupancy cold {probe['occupancy_cold']:.4f}, pixel order "
        f"{probe['occupancy_pixel']:.4f}, warm {probe['occupancy_warm']:.4f}; render s cold "
        f"{probe['render_s']:.5f}, pixel order {probe['render_s_pixel']:.5f}, warm "
        f"{probe['render_s_warm']:.5f}; sweep roofline {probe['roofline_s'] * 1e3:.3f} ms = "
        f"{probe['roofline_share_cold']:.3f} of cold, {probe['roofline_share_warm']:.3f} of warm; "
        f"fma peak {probe['peak_tflops']:.2f} TFLOP/s, chain {probe['chain_tflops']:.2f} TFLOP/s [{smi}]")

    # 10. the long render
    small_long = phase_long_render_small()
    say(f"phase 10a long render (150x100, spp 64, batches of 10): the kernel's accumulated image "
        f"bit-identical to the plain version's; render_kernel launches a batch {small_long['launches']}; "
        f"plain accumulation {small_long['plain_s']:.2f}s [{smi}]")
    say(f"phase 10c retry: a NaN batch at spp {small_long['retried_at'][0]} and a raised one at spp "
        f"{small_long['retried_at'][1]} rendered again ({small_long['calls']} batch renders for 7 "
        f"batches); the recovered image bit-identical to the fault-free run")
    long = phase_long_render_resume(REPO / "build")
    f, r = long["first"], long["resumed"]
    say(f"phase 10b resumed render (CLI, gpu preset {r.config.image_width}x{r.config.image_height}, "
        f"--checkpoint): {f.batches} batches to 250 spp in {f.render_s:.3f}s, then {r.batches} batches to "
        f"{r.config.samples_per_pixel} spp in {r.render_s:.3f}s; render_kernel launches "
        f"{long['launches']['render_kernel']}; max abs off the exact mean of its 500 samples "
        f"{long['max_abs_err']:.3e} (gate {LONG_RENDER_GATE}); one 500-spp render_cuda "
        f"({long['one_s']:.3f}s), bit-identical to the float32 sum of the samples rendered one by one "
        f"(sample_offset 0-499), is {long['one_err']:.3e} off that mean and {long['vs_one']:.3e} off the "
        f"resumed image, with {long['u8_off']} of {long['u8_values']} 8-bit values one level apart, "
        f"none more; a checkpoint save {long['save_s']:.3f}s ({long['sizes'][0]:.1f} MB), np.savez "
        f"of the same arrays {long['save_raw_s']:.3f}s ({long['sizes'][1]:.1f} MB) [{smi}]")
    long_times = {preset: phase_long_render_times(preset) for preset in ("gpu", "cpu-mt")}
    for preset, t in long_times.items():
        c = t["config"]
        say(f"phase 10d long render, {preset} preset ({c.image_width}x{c.image_height}, "
            f"{c.samples_per_pixel} spp, CLI --no-output, {len(t['batch_s'])} batches of "
            f"{c.samples_per_pixel // 10}): first batch {t['batch_s'][0]:.4f}s, then "
            + ", ".join(f"{b:.4f}" for b in t["batch_s"][1:])
            + f" s; total {t['total_s']:.3f}s = {t['mrays']:.2f} Mrays/s, steady {t['steady_mrays']:.2f} "
            f"Mrays/s; peak memory {t['peak_gb']:.3f} GB; the warm-cache fill {t['fill_ms']:.3f} ms = "
            f"{t['fill_share']:.2%} of a batch ({t['batch_warm_s']:.4f}s with the fill, "
            f"{t['batch_nowarm_s']:.4f}s without, medians of 3 in turns: {t['fill_share_turns']:.2%}) "
            f"[{smi}]")
    for preset in ("gpu", "cpu-mt"):
        e = phase_long_render_kernel_vs_plain(preset)
        say(f"phase 10e kernel vs plain, {preset} preset, a batch of {LONG_BATCH} spp at sample_offset "
            f"{LONG_OFFSET}: one pass over all {e['n']} lanes (budget {e['budget']}, "
            f"{e['full_iters']:.0f} lane-iterations, {e['started']} samples started) bit-identical "
            f"(plain {e['full_plain_s']:.2f}s); the whole batch ({cr.DEFAULT_PASSES} passes with "
            f"compaction) on {e['n_lanes']} pixels drawn across the image bit-identical, "
            f"{e['sub_iters']:.0f} lane-iterations, kernel {e['sub_s']:.4f}s, plain "
            f"{e['sub_plain_s']:.2f}s [{smi}]")

    # 11. sharding
    torch.cuda.empty_cache()
    small_cfg = PRESETS["bench"]
    cam24 = make_camera_from_config(dataclasses.replace(small_cfg, image_width=24), DEVICE)
    check((cam24.image_width, cam24.image_height) == (24, 16), "phase 11: the small camera is not 24x16")
    shard = phase_sharding_ranks(scene, cam, cam24, cam_small, REPO / "build" / "sharding")

    def worst(d):
        return max(d.values())

    for label, r in shard.items():
        phase = "11a" if label == "1x1" else "11b"
        image = ("bit-identical to render_cuda" if label.split("x")[1].startswith("1") else
                 f"the rank-order composite's bits, {r['image_err']:.2e} off render_cuda")
        if label == "1x1":
            grads = "loss and gradients render_grads_cuda's bits"
        elif "vs_exact" in r:
            grads = (f"loss {r['loss_err']:.2e} relative off one device; gradients, in gates of rtol "
                     f"{SHARD_GRAD_RTOL} + atol {SHARD_GRAD_ATOL}: {worst(r['vs_one']):.3f} off one device, "
                     f"{worst(r['vs_exact']):.3f} off the exact sum (one device {worst(r['one_vs_exact']):.3f}), "
                     f"at 64x32 {worst(r['small']['vs_one']):.3f} off one device (loss "
                     f"{r['small']['loss_err']:.2e})")
        else:
            grads = (f"loss {r['loss_err']:.2e} relative off one device; gradients {worst(r['vs_one']):.3f} "
                     f"of the gate off one device")
        say(f"phase {phase} sharded {label} ({'24x16' if '@' in label else 'bench preset'}): image "
            f"{image}; {grads}; launches {r['launches']}; forward cold {r['render_cold_s']:.4f}s, warm "
            + ", ".join(f"{t:.4f}" for t in r["render_warm_s"]) + "s; step "
            + ", ".join(f"{t:.4f}" for t in r["step_s"]) + "s; collectives' share of the last forward "
            + ", ".join(f"{c:.3f}" for c in r["render_coll_share"]) + " and step "
            + ", ".join(f"{c:.3f}" for c in r["step_coll_share"]) + " by rank; peak memory "
            + ", ".join(f"{g:.3f}" for g in r["peak_gb"]) + f" GB by rank [{smi}]")
    shard_cli = phase_sharding_cli(out, REPO / "build")
    say(f"phase 11c torchrun, 2 ranks over gloo: --preset bench --mesh 2 in {shard_cli['mono_s']:.1f}s, "
        f"rank 0's PPM phase 6's bytes ({shard_cli['mono_line']}); --mesh 1,2 --spp 64 --spp-batch 15 "
        f"--checkpoint in {shard_cli['batched_s']:.1f}s, batches {shard_cli['batches']}, the checkpoint the "
        f"fold of each batch's rank-order composite bit for bit ({shard_cli['batched_line']}) [{smi}]")
    dry = phase_sharding_dryrun()
    say("phase 11d dryrun_multichip on the card: " + "; ".join(
        f"{n} ranks, mesh {d['mesh']}, loss {d['loss']:.6g}, {d['s']:.1f}s" for n, d in dry.items()))
    sharded_launches = {name: {label: r["launches"][name] for label, r in shard.items()}
                        for name in PATH_KERNELS}

    # 12. the book milestones
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    miles, miles_launches = phase_milestones_full_width()
    for name, r in miles.items():
        say(f"phase 12a {name} ({r['shape']}, spp {r['spp']}, depth {r['depth']}; {r['active']} of "
            f"{r['slots']} slots active): render_kernel launches {r['launches']}; warm render "
            f"{r['warm_s']:.4f}s = {r['mrays_per_s']:.2f} Mrays/s (cold {r['cold_s']:.4f}s, the same bits); "
            f"{r['iters']:.0f} lane-iterations; bound {r['bound_ms']:.3f} ms by {r['bound_by']} over the "
            f"{r['active']} active slots ({r['bound_ms'] / (r['warm_s'] * 1e3):.2%} of the warm render), "
            f"{r['bound_padded_ms']:.3f} ms over all {r['slots']} the sweep tests "
            f"({r['bound_padded_ms'] / (r['warm_s'] * 1e3):.1%}); finite, mean {r['mean']:.4f} [{smi}]")
    lanes = phase_milestones_kernel_vs_plain()
    say(f"phase 12b kernel vs plain, {MILESTONE_LANES} pixels drawn across each image at the book's "
        f"size ({cr.DEFAULT_PASSES} passes with compaction): bit-identical radiance and work on all "
        f"{len(lanes)}; " + "; ".join(f"{n} {r['iters']:.0f} lane-iterations, kernel {r['kernel_s']:.4f}s, "
                                      f"plain {r['plain_s']:.2f}s" for n, r in lanes.items()) + f" [{smi}]")
    probes_cf = phase_closed_form_probes()
    say("phase 12c closed-form probes through the kernel (images bit-identical to the plain version's): "
        + "; ".join(r.line() for r in probes_cf.values()))
    shading = phase_shading_renders()
    say("phase 12d shading renders at full width on the card (JAX defaults: seconds), and their first "
        f"{SHADING_CPU_SPP} samples against the CPU (block MAD on the 12x6 grid, gate {SHADING_CARD_GATE:g}; "
        f"pixels > 1e-3 apart, at most {SHADING_CARD_SHARE:.2%}; CPU seconds; the card under seed 1 against "
        "the CPU under seed 0, which must miss): " + "; ".join(
            f"{n} {r['shape']} card {r['card_s']:.3f}s, {r['mad']:.2e}, {r['differ']:.4%}, CPU "
            f"{r['cpu_s']:.2f}s, card under seed 1 {r['fault'][0]:.2e}, {r['fault'][1]:.4%}"
            for n, r in shading.items())
        + f"; first_gradient_image 1920x1080 byte-equal [{smi}]")
    say(f"phase 12 took {time.perf_counter() - t12:.1f}s")

    # 13. the gallery and the scheduling sweep
    from ray_tracing_in_one_weekend_tpu_torch.scripts import render_gallery as rg

    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as gallery_dir:
        gallery, gallery_launches = phase_gallery(gallery_dir)
        manifest_info = phase_manifest(gallery_dir, gallery, smi)
    for preset, c in gallery.items():
        e0, e1 = c.seed0.entry, c.seed1.entry
        say(f"phase 13{'a' if preset == 'cpu' else 'b'} gallery {preset} ({e0['width']}x{e0['height']}, "
            f"{e0['spp']} spp in batches of {GALLERY_BATCH}, {e0['scene']}): render_kernel launches a batch "
            f"{list(c.seed0.launches)}, seed 1 {list(c.seed1.launches)}; seconds a batch "
            + ", ".join(f"{t:.4f}" for t in c.seed0.batch_s) + f" = {e0['render_seconds']:.3f}s, "
            f"{e0['mrays_per_s']:.2f} Mrays/s steady, {e0['mrays_per_s_incl_first']:.2f} incl the first "
            f"(seed 1 {e1['render_seconds']:.3f}s)"
            + (f"; vs reference golden: {c.vs_golden.line()} (gates MAD < {rg.GOLDEN_GATES['mad']:g}, p99 <= "
               f"{rg.GOLDEN_GATES['p99']:g}, max <= {rg.GOLDEN_GATES['max']:g}); PNG read back byte-equal"
               if c.vs_golden is not None else "")
            + f"; vs TPU {Path(c.tpu_path).name}: {c.vs_tpu.line()}; noise (seed 0 vs seed 1) MAD "
            f"{c.noise:.4f}; seed 1 vs TPU: {c.seed1_vs_tpu.line()} (gate: seed 0 below {rg.TPU_GATE} x noise "
            f"= {rg.TPU_GATE * c.noise:.4f}, seed 1 not) [{smi}]")
    say(f"phase 13c manifest: {manifest_info['entries']} entries, one a render, each with digest "
        f"{manifest_info['digest'][:16]}..., git commit {manifest_info['git_commit']} and the card; the digest "
        f"moves with a byte of a copied render_device.cuh and not with a docstring of a copied cuda_render.py")
    sweep, sweep_launches = phase_sweep()
    best = min(sweep, key=lambda r: r.best_s)
    say("phase 13d scheduling sweep (bench preset, cold, 1 untimed + 3 timed renders a configuration, every "
        "image equal to the default schedule's): " + "; ".join(r.line() for r in sweep)
        + f"; best tile={best.tile} budget={best.budget} passes={best.passes} {best.best_s * 1e3:.3f} ms "
        f"[{smi}]")
    lanes13 = phase_gallery_kernel_vs_plain()
    say(f"phase 13e kernel vs plain at the gallery's last batch ({GALLERY_BATCH} spp at sample_offset "
        f"{GALLERY_SPP - GALLERY_BATCH}, {cr.DEFAULT_PASSES} passes with compaction) on {GALLERY_LANES} pixels "
        f"drawn across each image: bit-identical radiance and work; " + "; ".join(
            f"{p} {r['iters']:.0f} lane-iterations, kernel {r['kernel_s']:.4f}s, plain {r['plain_s']:.2f}s"
            for p, r in lanes13.items()) + f" [{smi}]")
    say(f"phase 13 took {time.perf_counter() - t13:.1f}s")

    # 14. the differentiable render under torch.autograd
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    ag_loss, ag_small = phase_autograd_small(ref, cam_small)
    say(f"phase 14a autograd render (64x32, spp 4, depth 8): no kernel launched; render(differentiable=True) "
        f"bit-identical to render_cuda; render_grads vs render_grads_cuda: loss {ag_loss:.2e} relative, "
        "gradients rel L2 " + ", ".join(f"{k} {e:.2e}" for k, e in ag_small.items()) + f" (gate {GRAD_GATE})")
    ag_sub, ag_sub_s = phase_autograd_subset(scene, cam)
    say(f"phase 14b autograd at the bench preset, phase 7b's 16384 drawn pixels: no kernel launched; "
        f"render_pixels bit-identical to render_cuda there; fwd+bwd {ag_sub_s:.2f}s; gradient vs "
        f"build.grad_pass on the same lanes rel L2 " + ", ".join(f"{k} {e:.2e}" for k, e in ag_sub.items())
        + f" (gate {GRAD_GATE}) [{smi}]")
    ag = phase_autograd_step(scene, cam)
    say(f"phase 14c autograd step (parallel.dist.render_grads_pcg, bench preset, zero target, chunk {ag['chunk']} "
        f"pixels): no kernel launched; {ag['seconds']:.2f}s = {ag['mrays']:.4f} Mrays/s; peak memory "
        f"{ag['peak_gb']:.3f} GB; the forward alone (render, no tape) {ag['forward_s']:.2f}s, bit-identical "
        f"to render_cuda; vs render_grads_cuda: loss {ag['loss_err']:.2e} relative, gradients rel L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in ag["errs"].items())
        + f" (gate {GRAD_GATE} but on " + ", ".join(EXACT_GRAD_FIELDS) + "); against the exact float64 sum "
        "of the kernels' events: " + ", ".join(f"{k} kernels {e_k:.2e} (gate {GRAD_GATE}), autograd {e_a:.2e} "
                                                f"(bound {most:.2e})" for k, (e_k, e_a, most) in ag["exact"].items())
        + f" [{smi}]")
    demo_s = phase_autograd_demo()
    say(f"phase 14d inverse_render --backend pallas --grad autograd: exit 0 (albedo error at least halved) in "
        f"{demo_s:.1f}s")
    say(f"phase 14 took {time.perf_counter() - t14:.1f}s")

    # 15. the jnp backend on threefry keys
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    jnp_active, jnp_mix = phase_jnp_scene()
    say(f"phase 15a scene: cover_scene(0) equals the committed JAX table in every field; the bench "
        f"preset's scene has {jnp_active} active spheres, lambertian/metal/dielectric {jnp_mix}")
    jnp_run, jnp_launches = phase_jnp_cli()
    say(f"phase 15b main path: CLI --preset bench --backend jnp, {jnp_launches} threefry_render_kernel "
        f"launch(es), no render_kernel; first render {jnp_run.first_s:.4f}s (first use included) = "
        f"{jnp_run.config.image_width * jnp_run.config.image_height * jnp_run.config.samples_per_pixel / jnp_run.first_s / 1e6:.2f} "
        f"Mrays/s, timed render {jnp_run.render_s:.4f}s = {jnp_run.mrays_per_s:.2f} Mrays/s [{smi}]")
    jk = phase_jnp_kernel_vs_plain()
    say(f"phase 15c kernel vs plain, {JNP_LANES} bench pixels drawn across the image (10 spp, depth 50): "
        f"bit-identical, the same work map (flipped {jk['agree'].flipped_frac:.4%}, max "
        f"{jk['agree'].max_abs_err:.2e}); plain {jk['plain_s']:.2f}s; 77 pixels, 1 pixel, spp 1 and samples 5-7 "
        f"bit-identical with their work maps; the whole bench image in reversed and random order the identity "
        f"order's bits and work map [{smi}]")
    jnp_reading = sweep_readings.threefry_reading(
        res.log, res.path, lambda k: build.blocks_per_sm(k, sweep_readings.TILE, sweep_readings.N_SLOTS))
    say(f"phase 15d {jnp_reading.line()}; persistent grid {jk['grid']} blocks of 128; full bench image "
        f"({jk['n_pixels']} pixels, {jk['spp']} spp): {jk['ms']:.3f} ms = {jk['mrays']:.2f} Mrays/s, "
        f"{jk['sweeps']:.0f} sweeps over {jnp_active} active spheres, bound {jk['bound'][0]:.3f} ms by "
        f"{jk['bound'][1]} at {JNP_OPS_PER_SPHERE_TEST} operations a test ({jk['bound'][0] / jk['ms']:.1%} of "
        f"bound; at {JNP_OPS_PER_SPHERE_TEST_UNSCALED}, -2 (o.c) a test: {jk['bound_17'][0]:.3f} ms, "
        f"{jk['bound_17'][0] / jk['ms']:.1%}); the image twice in one launch {jk['ms_twice']:.3f} ms, so the "
        f"ramp and tail 2 x one - two = {jk['tail_ms']:.3f} ms; work map: largest pixel {jk['max_pixel_sweeps']} "
        f"sweeps, mean {jk['mean_pixel_sweeps']:.2f} a pixel, {jk['sweeps_per_thread']:.1f} a thread of the grid "
        f"[{smi}]")
    jg = phase_jnp_gallery()
    say(f"phase 15e gallery jnp image (cpu preset 1200x800, cover_scene_reference, 500 spp in batches of "
        f"{GALLERY_BATCH}, depth 50): seed 0 {jg['seconds'][0]:.3f}s = {jg['mrays'][0]:.2f} Mrays/s, seed 1 "
        f"{jg['seconds'][1]:.3f}s; launches {jg['launches']}; vs TPU {JNP_GALLERY}: {jg['vs_tpu'].line()}; "
        f"noise (seed 0 vs seed 1) MAD {jg['noise']:.4f}; seed 1 vs TPU MAD {jg['seed1_vs_tpu'].mad:.4f} "
        f"(gate: seed 0 below {rg.TPU_GATE} x noise = {rg.TPU_GATE * jg['noise']:.4f}, seed 1 not) [{smi}]")
    say(f"phase 15 took {time.perf_counter() - t15:.1f}s")

    # 16. the keyed gradient
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    ks = phase_keyed_small()
    say("phase 16a keyed gradient at 64x32 (parallel.dist.render_grads, key 0): the recording forward's image "
        "and work map threefry_render_kernel's bits; the three kernels launched once each; the loss the bits of "
        "the loss of threefry_render_kernel's image; vs render_grads_autograd on the card (no launch) rel L2 " + "; ".join(f"{label} " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                                               for label, errs in ks.items()) + f" (gate {GRAD_GATE}) [{smi}]")
    kb = phase_keyed_subset()
    say(f"phase 16b keyed train step at the bench preset, phase 15c's {JNP_LANES} drawn pixels: the recording "
        f"forward's image and work map threefry_render_kernel's bits and the plain recording's; its {kb['n_events']} "
        f"records in logical order the plain replay's words 0-13 bit for bit; reverse events vs plain: winners "
        f"equal, rel L2 {kb['event_err']:.2e} (gate {ADJOINT_GATE}; by bounces from the path's end: "
        + ", ".join(f"{b} {e:.2e}" for b, e in kb["event_err_by_back"].items()) + "); the plain per-path reverse "
        f"on the kernel's arena the plain reverse's bits; the reduction the ordered plain reduction's bits; the "
        f"gradient bit-identical run to run, for a shuffled pixel order and through an arena of 1024 records "
        f"({kb['overflow_reruns']} re-run); plain recording {kb['record_plain_ms']:.0f} ms, plain reverse "
        f"{kb['reverse_plain_ms']:.0f} ms [{smi}]")
    kc = phase_keyed_step(scene, cam, parent)
    b, km = kc["bounds"], kc["kernel_ms"]
    reduce_step_ms = km["reduce_chunks"] + km["reduce_partials"]
    say(f"phase 16c keyed train step (parallel.dist.render_grads, bench preset, zero target): cold "
        f"{kc['cold_s']:.4f}s = {kc['cold_mrays']:.2f} Mrays/s ({kc['cold_reruns']} re-run of the recording "
        f"forward); warm " + ", ".join(f"{t:.4f}" for t in kc["warm_s"])
        + "s = " + ", ".join(f"{r:.2f}" for r in kc["mrays"]) + " Mrays/s; launches "
        + ", ".join(f"{k} {kc['launches'][k]}" for k in (*KEYED_KERNELS, "threefry_record_rerun",
                                                          "threefry_render_kernel"))
        + f", replay kernels in the profiled step {kc['replay_launches']}; peak memory {kc['peak_gb']:.3f} GB "
        f"(the step's own {kc['step_gb']:.3f} GB above what earlier phases hold); "
        f"two warm steps under torch.profiler, a step {kc['wall_ms']:.3f} ms wall, device busy {kc['busy_ms']:.3f} ms "
        f"traced, idle share {kc['idle']:.4f} ({kc['untraced']} hand-written launches untraced, none filled in); "
        f"device ms a traced launch " + ", ".join(f"{k} {v:.3f}" for k, v in km.items())
        + f" ({kc['n_events']} sweeps, {kc['lit_records']} on paths that reached the sky, {kc['dark_paths']} "
        f"paths dark); alone (events) the recording forward {kc['record_alone_ms']:.3f} ms, the forward kernel "
        f"{kc['forward_ms']:.3f} ms, the reverse {kc['reverse_alone_ms']:.3f} ms, the reduction "
        f"{kc['reduce_ms']:.3f} ms (index_add_ {kc['library_ms']:.3f} ms); bounds and shares in the step: "
        f"recording forward {b['record'][0]:.3f} by {b['record'][1]} ({b['record'][0] / km['record']:.1%}), "
        f"reverse {b['reverse'][0]:.3f} by {b['reverse'][1]} ({b['reverse'][0] / km['reverse']:.1%}), "
        f"reduction {b['reduce'][0]:.3f} by {b['reduce'][1]} ({b['reduce'][0] / reduce_step_ms:.1%}); the "
        f"forward kernel's bound {b['forward'][0]:.3f} [{smi}]")
    if kc["parent_runs"] is not None:
        pr = kc["parent_runs"]
        say("phase 16c against the parent (probes/keyed_step.py in fresh processes, parent, this, this, parent): "
            + "; ".join(f"{who} warm s " + ", ".join(f"{t:.4f}" for t in r["warm_s"]) + f" (cold {r['cold_s']:.4f}, "
                        f"own memory {r['step_memory_gb']:.3f} GB; two profiled steps: idle share "
                        f"{r['profile']['idle']:.4f}, {r['profile']['wall_ms']:.3f} ms wall, "
                        f"{r['profile']['busy_ms']:.3f} ms busy, launches traced {r['profile']['launches_traced']} "
                        f"of {r['profile']['launches_made']})" for who in ("parent", "this") for r in pr[who])
            + f"; median warm this / parent "
            f"{statistics.median(t for r in pr['this'] for t in r['warm_s']) / statistics.median(t for r in pr['parent'] for t in r['warm_s']):.3f}; "
            f"the gradient the parent's bits [{smi}]")
    say(f"phase 16c vs render_grads_autograd on the card (chunks of {KEYED_ORACLE_CHUNK} pixels, no launch): "
        f"{kc['oracle_s']:.2f}s, peak memory {kc['oracle_peak_gb']:.3f} GB; loss the kernels' bits; gradients rel L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in kc["errs"].items())
        + f" (gate {GRAD_GATE} but on " + ", ".join(EXACT_GRAD_FIELDS) + "); from the exact float64 sum of the "
        "kernels' events (kernels, autograd): " + ", ".join(f"{k} {a:.2e}, {o:.2e}" for k, (a, o) in kc["vs_exact"].items())
        + "; held: " + ", ".join(f"{k} kernels {e_k:.2e} (gate {GRAD_GATE}), autograd {e_a:.2e} (bound {most:.2e})"
                                 for k, (e_k, e_a, most) in kc["exact"].items()) + f" [{smi}]")
    demo16_s, demo16_launches = phase_keyed_demo()
    say(f"phase 16d inverse_render (--backend jnp, the default): exit 0 (albedo error at least halved) in "
        f"{demo16_s:.1f}s; launches " + ", ".join(f"{k} {demo16_launches[k]}" for k in KEYED_KERNELS))
    ke, ke_s = phase_keyed_ranks(REPO / "build" / "sharding")
    say(f"phase 16e keyed step in 2 gloo ranks (64x32, spp 4, depth 8, cover_scene(0)) in {ke_s:.1f}s: "
        + "; ".join(f"{m}: image {'one process' if r['image_err'] == 0.0 else 'the rank-order mean'}'s bits "
                    f"({r['image_err']:.2e} off one process), loss {r['loss_err']:.2e} relative, gradients "
                    f"{max(r['vs_one'].values()):.3f} of rtol {SHARD_GRAD_RTOL} + atol {SHARD_GRAD_ATOL} off one "
                    f"process, step s " + ", ".join(f"{t:.3f}" for t in r["step_s"]) + ", launches by rank "
                    + str(r["launches"]) for m, r in ke.items()) + f" [{smi}]")
    say(f"phase 16 took {time.perf_counter() - t16:.1f}s")

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
        "launches_long_render": long["launches"]["render_kernel"],
        "launches_sharded": sharded_launches["render_kernel"],
        "long_render_max_abs_err": long["max_abs_err"],
        "long_render_steady_mrays_per_s": {k: t["steady_mrays"] for k, t in long_times.items()},
        "render_s": run.render_s,
        "render_warm_hit": run.warm_hit,
        "mrays_per_s": run.mrays_per_s,
        "pass_times_s": times,
        "launches_milestones": miles_launches,
        "milestones": {n: {k: r[k] for k in ("shape", "launches", "warm_s", "mrays_per_s", "bound_ms",
                                              "bound_by", "bound_padded_ms")} for n, r in miles.items()},
        "milestone_lanes_bit_identical": {n: MILESTONE_LANES for n in lanes},
        "closed_form": {n: {"value": r.value, "limit": r.limit} for n, r in probes_cf.items()},
        "launches_gallery": gallery_launches,
        "gallery": {p: {"seconds": c.seed0.entry["render_seconds"], "steady_mrays_per_s": c.seed0.entry["mrays_per_s"],
                        "vs_tpu_mad": c.vs_tpu.mad, "vs_tpu_p99": c.vs_tpu.p99, "vs_tpu_max": c.vs_tpu.max,
                        "vs_tpu_equal_pixels": c.vs_tpu.equal, "vs_tpu_bias": c.vs_tpu.bias, "noise_mad": c.noise,
                        "seed1_vs_tpu_mad": c.seed1_vs_tpu.mad} for p, c in gallery.items()},
        "gallery_vs_golden": dataclasses.asdict(gallery["cpu"].vs_golden),
        "gallery_lanes_bit_identical": {p: GALLERY_LANES for p in lanes13},
        "launches_sweep": sweep_launches,
        "sweep_best_ms": {f"{r.tile}:{r.budget}:{r.passes}": r.best_s * 1e3 for r in sweep},
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
        "launches_sharded": sharded_launches["grad_replay"],
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
        "launches_sharded": sharded_launches["grad_reverse"],
        "rel_l2": sub["event_err"],
        "rel_l2_64x32": small["event_err"],
        "rel_l2_by_back": sub["event_err_by_back"],
        "rel_l2_by_back_64x32": small["event_err_by_back"],
    }, {
        "name": "grad_reduce",
        "route": "cuda",
        "source": f"{PKG}/csrc/grad_kernel.cu (grad_reduce_chunks + grad_reduce_partials)",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_grad.py:476",
        "launches": step["launches"]["grad_reduce"],
        "max_abs_err": sub["reduce_abs_err"],
        "ms": sub["reduce_ms"],
        "plain_ms": sub["reduce_plain_ms"],
        "tolerance": "bit-identical to the ordered plain reduction (_reduce_events_ordered, torch.equal) at "
                     "64x32, on 16384 cost-sorted bench lanes and at full width; rel L2 <= 1e-5 against "
                     "index_add over the same events (summation order); max_abs_err against index_add",
        "bound_ms": sub["reduce_bound"][0],
        "bound_by": sub["reduce_bound"][1],
        "bound_ms_whole_events": sub["reduce_bound_whole"][0],
        "library_ms": sub["reduce_library_ms"],
        "library": "one index_add_ of the events' 13 cotangent rows into [13, N]",
        "shapes": "ms, plain_ms, bound_ms, library_ms on 16384 cost-sorted bench lanes; *_full_width and "
                  "ms_chunks, ms_partials, parent_ms (medians of 5 rounds in turns) on the train step's events; "
                  "bound_ms counts the bytes the events need (32 an event with no sphere, 64 the others), "
                  "*_whole_events 64 bytes every event",
        "bound_ms_full_width": step["reduce_bound"][0],
        "bound_ms_full_width_whole_events": step["reduce_bound_whole"][0],
        "ms_full_width": step["reduce_ms"],
        "library_ms_full_width": step["reduce_library_ms"],
        "ms_pair_full_width": mine["pair"],
        "ms_chunks": mine["chunks"],
        "ms_partials": mine["partials"],
        "parent_ms": med["parent"]["pair"] if "parent" in med else None,
        "parent_ms_chunks": med["parent"]["chunks"] if "parent" in med else None,
        "parent_ms_partials": med["parent"]["partials"] if "parent" in med else None,
        "launches_sharded": sharded_launches["grad_reduce"],
        "chunks_blocks_per_sm": reduce_blocks,
        "no_sphere_share": stats["no_sphere_share"],
        "heaviest_sphere_chunk_median": stats["heaviest_median"],
        "heaviest_sphere_chunk_max": stats["heaviest_max"],
        "rel_l2": sub["reduce_err"],
    }, *(probe_entry(name, v, readings.get(name)) for name, v in probes.items()), {
        "name": "threefry_render_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/threefry_render_kernel.cu (+ threefry.cuh)",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/render.py:141 (render_image -> ops/integrator.py:50 "
                    "trace_rays; no Pallas kernel: the jnp path)",
        "launches": jnp_launches,
        "max_abs_err": jk["agree"].max_abs_err,
        "ms": jk["ms"],
        "plain_ms": jk["plain_s"] * 1e3,
        "tolerance": "bit-identical to the plain version (render_flat_threefry), work map too, on 16384 drawn "
                     "bench pixels and the edge cases; phase 3's gate (<= 2% flipped, block means) checked first; "
                     "the whole image in any pixel order the same bits",
        "bound_ms": jk["bound"][0],
        "bound_by": jk["bound"][1],
        "library_ms": None,
        "shapes": "ms and bound_ms: the whole bench image (1200x800, 10 spp, depth 50); plain_ms on the 16384 "
                  "drawn pixels; launches from the CLI's main path (phase 15b)",
        **jnp_reading.fields(),
        "sweeps": jk["sweeps"],
        "design": "persistent grid (SMs x resident blocks of 128) fed by a pixel queue with warp-aggregated "
                  "atomics; the keyed sweep in groups of 8 tests with one sign test a group and a loop over its "
                  "roots; __maxnreg__ 72",
        "grid_blocks": jk["grid"],
        "ms_twice": jk["ms_twice"],
        "tail_ms": jk["tail_ms"],
        "max_pixel_sweeps": jk["max_pixel_sweeps"],
        "bound_ms_17_ops": jk["bound_17"][0],
        "cli_first_s": jnp_run.first_s,
        "cli_render_s": jnp_run.render_s,
        "cli_mrays_per_s": jnp_run.mrays_per_s,
        "gallery_seconds": jg["seconds"][0],
        "gallery_mrays_per_s": jg["mrays"][0],
        "gallery_vs_tpu_mad": jg["vs_tpu"].mad,
        "gallery_noise_mad": jg["noise"],
        "gallery_seed1_vs_tpu_mad": jg["seed1_vs_tpu"].mad,
        "launches_gallery": jg["launches"],
    }, {
        "name": "threefry_record_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/threefry_grad_kernel.cu (+ threefry_device.cuh, threefry.cuh)",
        "replaces": KEYED_REPLACES,
        "launches": kc["launches"]["threefry_record"],
        "max_abs_err": kb["record_abs_err"],
        "ms": km["record"],
        "plain_ms": kb["record_plain_ms"],
        "tolerance": "image and work map bit-identical to threefry_render_kernel's (64x32, the 16384 drawn bench "
                     "pixels, the bench image) and to the plain recording's (record_plain); records in logical "
                     "order bit-identical to the plain replay's words 0-13 (replay_records_plain) on the 16384 "
                     f"drawn bench pixels; the keyed gradient per field rel L2 <= {GRAD_GATE} against "
                     "render_grads_autograd at 64x32 and at the bench preset",
        "bound_ms": b["record"][0],
        "bound_by": b["record"][1],
        "library_ms": None,
        "shapes": "ms (device time by torch.profiler inside a warm step) and bound_ms at the bench preset "
                  "(1200x800, 10 spp, depth 50); plain_ms the plain recording of the 16384 drawn pixels; launches "
                  "from 16c's steps (a re-run counted in both)",
        **keyed_resources.get("threefry_record_kernel", {}),
        "sweeps": kc["n_events"],
        "ms_alone": kc["record_alone_ms"],
        "forward_kernel_ms_alone": kc["forward_ms"],
        "forward_kernel_bound_ms": b["forward"][0],
        "reruns_cold": kc["cold_reruns"],
        "reruns_total": kc["launches"]["threefry_record_rerun"],
        "replay_launches": kc["replay_launches"],
        "step_cold_s": kc["cold_s"],
        "step_warm_s": kc["warm_s"],
        "step_mrays_per_s": kc["mrays"],
        "step_peak_memory_gb": kc["peak_gb"],
        "step_memory_above_live_gb": kc["step_gb"],
        "step_idle_share": kc["idle"],
        "step_untraced_launches": kc["untraced"],
        "parent_steps": kc["parent_runs"],
        "rel_l2_64x32": ks,
        "rel_l2_bench": kc["errs"],
        "rel_l2_vs_exact_bench": kc["vs_exact"],
        "oracle_s": kc["oracle_s"],
        "oracle_peak_memory_gb": kc["oracle_peak_gb"],
        "launches_sharded": {m: r["launches"] for m, r in ke.items()},
    }, {
        "name": "threefry_reverse_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/threefry_grad_kernel.cu (+ threefry_device.cuh)",
        "replaces": KEYED_REPLACES,
        "launches": kc["launches"]["threefry_reverse"],
        "max_abs_err": kb["event_abs_err"],
        "ms": km["reverse"],
        "plain_ms": kb["reverse_plain_ms"],
        "tolerance": f"events against the plain reverse (reverse_records_plain) on the plain replay's records: "
                     f"winners equal, cotangent words rel L2 <= {ADJOINT_GATE}; max_abs_err on the 16384 drawn pixels",
        "bound_ms": b["reverse"][0],
        "bound_by": b["reverse"][1],
        "library_ms": None,
        "shapes": "ms (device time by torch.profiler inside a warm step) and bound_ms at the bench preset; "
                  "bound_ms counts each path's table entries, the records of paths that reached the sky whole, "
                  "a 32-byte sector of each dark path's last record, and every event written; plain_ms on the "
                  "16384 drawn pixels; launches from 16c's steps",
        **keyed_resources.get("threefry_reverse_kernel", {}),
        "ms_alone": kc["reverse_alone_ms"],
        "records_on_lit_paths": kc["lit_records"],
        "dark_paths": kc["dark_paths"],
        "rel_l2": kb["event_err"],
        "rel_l2_by_back": kb["event_err_by_back"],
        "reduce_ms_in_step": reduce_step_ms,
        "reduce_bound_ms": b["reduce"][0],
        "launches_grad_reduce_keyed": kc["launches"]["grad_reduce"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
