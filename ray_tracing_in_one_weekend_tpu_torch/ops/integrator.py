"""Iterative path tracing in plain PyTorch, differentiable by torch.autograd.

The port's counterpart of ray_tracing_in_one_weekend_tpu/ops/integrator.py
(`trace_rays`, :50-120), twice: `trace_rays_threefry` on the JAX package's
threefry keys (the jnp backend: see its docstring; `ray_color`, :123-132
there, is its alias), and `trace_rays` on
the port's own PCG streams, described here: each bounce runs
the forward render's device functions (`ops/cuda_render.py`) with the
draw counter 8 + 16·depth, so a ray's radiance is the bits `render_cuda`
gives it. No kernel is launched: every operation is a PyTorch one, on
the device of the tensors it is given.

Per bounce of the rays still on their path:

* the sphere sweep (`_sweep_ts`, [N, L]) and its minimum run without the
  tape and on detached inputs, so autograd records no [N, L] tensor and
  forward-mode AD carries no tangent through them;
* the winner's t is recomputed from its parameter column with gradient,
  under the backward's guards (`cuda_grad._winner_t`: a safe column on
  misses, disc floored at 1e-12). The value is the sweep's and only the
  derivative is the recompute's (t_best + (t_rec - t_rec.detach())), so
  neither the floor nor an operation order can move a bit of the value;
* then the hit point and normal (`_surface`), the scatter
  (`_scatter_block`) and, on a miss, the sky (`_sky`).

The live rays are compacted by index each bounce, and the radiance is
written out of place (`index_copy`), so autograd sees no in-place write.
The loop stops when no ray is live: autograd records the bounces that
ran. (The JAX package runs a fixed trip count on its differentiable path
because JAX's reverse mode needs one.)

The gradient is the Monte-Carlo-discrete one of tests/test_grad.py:1-15:
the sampled paths' discrete decisions are constants. There is no ±1e6
clip (the JAX jnp path has none): the clip is a guard of the backward
kernels (`ops/cuda_grad.py`).
"""

from __future__ import annotations

import contextlib

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops import sampling
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import _winner_t
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    T_MISS,
    _as_i32,
    _scatter_block,
    _sky,
    _surface,
    _sweep_ts,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.intersect import hit_scene
from ray_tracing_in_one_weekend_tpu_torch.ops.materials import scatter_sampled

# Sky gradient endpoints (reference: src/gpu/camera.h:120-122).
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def trace_rays(p_mat, o, d, stream, t_min, max_depth, differentiable=False):
    """Trace a flat block of rays to radiance -> [3, L] float32.

    `p_mat` [16, N] is the packed scene (`pack_scene`), `o` and unit `d`
    [3, L] the rays, `stream` the (lo, hi) [1, L] uint32 words of each
    ray's PCG stream (as `_camera_ray_block` gives them), `t_min` the
    shadow-acne epsilon and `max_depth` the bounce limit. Miss: the sky,
    weighted by the attenuation so far, and the ray retires; absorbed or
    out of depth: it retires dark. `differentiable=False` runs under
    `torch.no_grad()`; with True autograd records the bounces, and
    gradients reach `p_mat` (and `o`, `d` if they require them)."""
    if not differentiable:
        with torch.no_grad():
            return _trace(p_mat, o, d, stream, t_min, max_depth)
    return _trace(p_mat, o, d, stream, t_min, max_depth)


def _trace(p_mat, o, d, stream, t_min, max_depth):
    lo, hi = stream
    n = o.shape[1]
    rad = torch.zeros(3, n, dtype=torch.float32, device=o.device)
    att = torch.ones(3, n, dtype=torch.float32, device=o.device)
    live = torch.arange(n, device=o.device)
    for depth in range(max_depth):
        with torch.no_grad():
            t_best, best = torch.min(
                _sweep_ts(o.detach(), d.detach(), p_mat.detach(), t_min), dim=0, keepdim=True
            )
        hit = t_best < T_MISS * 0.5
        pc, t_rec = _winner_t(o, d, p_mat[:, best[0]], hit, t_min)
        t = torch.where(hit, t_best + (t_rec - t_rec.detach()), 1.0)
        p, n_vec, front_face = _surface(o, d, t, pc)
        new_dir, mat_atten, ok = _scatter_block(
            d, n_vec, front_face, pc, (lo[:, live], hi[:, live]), 8 + 16 * depth
        )
        rad = rad.index_copy(1, live, rad[:, live] + torch.where(hit, 0.0, att * _sky(d)))
        if depth + 1 == max_depth:
            break
        keep = (hit & ok)[0].nonzero()[:, 0]
        if keep.numel() == 0:
            break
        live = live[keep]
        o, d, att = p[:, keep], new_dir[:, keep], (att * mat_atten)[:, keep]
    return rad


# ---------------------------------------------------------------------------
# The keyed path: the JAX package's jnp integrator on threefry keys.
# ---------------------------------------------------------------------------


def sky_color(direction: torch.Tensor) -> torch.Tensor:
    """Background gradient lerp(white, blue, 0.5 (unit_dir.y + 1)) for any
    (not necessarily unit) direction [..., 3] (reference:
    src/gpu/camera.h:119-123)."""
    a = 0.5 * (vm.unit_vector_fma(direction)[..., 1] + 1.0)
    blue = torch.tensor(SKY_BLUE, dtype=direction.dtype, device=direction.device)
    return vm.fma(a[..., None], blue, (1.0 - a)[..., None])


# Record words of the keyed recording forward (`build.threefry_record`; int
# fields as int32 bits): o, d, att at 0-8, then the winner (-1 for a miss),
# the trace key's two words, the bounce index and how the path goes on after
# the bounce; words 14-15 hold the arena index of the path's previous record
# there (here, and in `replay_records_plain`'s logical order, zero). The
# layout of the PCG records in words 0-13, so `cuda_grad._path_positions`
# walks both.
_REC_WINNER, _REC_K0, _REC_K1, _REC_DEPTH, _REC_END = 9, 10, 11, 12, 13
_END_NONE, _END_DARK, _END_SKY = 0, 1, 2  # goes on; ends without radiance; ends at the sky


def _record_rows(o, d, att, winner, keys, depth, end) -> torch.Tensor:
    """The records [L, 16] of one bounce of L rays."""
    with torch.no_grad():
        rows = torch.zeros(o.shape[0], 16, dtype=torch.float32, device=o.device)
        rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = o, d, att
        words = rows.view(torch.int32)
        words[:, _REC_WINNER] = winner.to(torch.int32)
        words[:, _REC_K0] = _as_i32(keys[0])
        words[:, _REC_K1] = _as_i32(keys[1])
        words[:, _REC_DEPTH] = depth
        words[:, _REC_END] = end.to(torch.int32)
    return rows


def trace_rays_threefry(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    keys,
    max_depth: int,
    differentiable: bool = False,
    return_work: bool = False,
    return_records: bool = False,
):
    """Trace a flat batch of rays to radiance [R, 3] on threefry keys: the
    JAX package's jnp `trace_rays` (integrator.py:50-120). With
    `return_work`, also the [R] int32 sweeps each ray ran: one a bounce it
    was live for, as `csrc/threefry_render_kernel.cu` counts them. With
    `return_records`, last, the sweeps as the recording forward records them
    (`_record_rows`): [(rays [L], records [L, 16])], one entry a bounce of
    the L rays still live, in bounce order.

    `origin`, `direction` [R, 3] (directions need not be unit), `keys` the
    rays' [R] keys (already folded with pixel and sample index). Bounce i
    draws `uniforms_b(keys, 5, domain=i)`: four for the Box-Muller unit
    sample, one for the dielectric's choice. A miss adds the sky times the
    attenuation so far and retires the ray; an absorbed ray retires dark,
    as does one still bouncing after `max_depth` bounces. The loop stops
    once no ray is live (the JAX function's `while_loop`; its fixed-trip
    `fori_loop` under differentiation gives the same values).

    The live rays are compacted by index each bounce and the radiance is
    written out of place, so with `differentiable=True` torch.autograd
    records the bounces that ran, and gradients reach the scene's center,
    radius, albedo, fuzz and ior (and `origin`, `direction` if they require
    them). Without it the trace runs under `torch.no_grad()`. No kernel is
    launched: this is the plain version of `csrc/threefry_render_kernel.cu`,
    on the device of its inputs."""
    ctx = contextlib.nullcontext() if differentiable else torch.no_grad()
    with ctx:
        n = origin.shape[0]
        rad = torch.zeros(n, 3, dtype=torch.float32, device=origin.device)
        att = torch.ones(n, 3, dtype=torch.float32, device=origin.device)
        live = torch.arange(n, device=origin.device)
        work = torch.zeros(n, dtype=torch.int32, device=origin.device)
        o, d, k = origin, direction, keys
        records = []
        for i in range(max_depth):
            rec = hit_scene(scene, o, d)
            work[live] += 1
            miss = ~rec.hit
            rad = rad.index_copy(0, live, rad[live] + torch.where(miss[:, None], att * sky_color(d), 0.0))
            last = i + 1 == max_depth or not bool(rec.hit.any())
            ok = torch.zeros_like(rec.hit)  # out of depth: every hit ends dark
            if not last:
                u = sampling.uniforms_b(k, 5, domain=i)
                unit_sample = sampling.unit_vector_from_uniforms(u[:, 0:4])
                new_dir, mat_att, ok = scatter_sampled(rec, d, unit_sample, u[:, 4])
            if return_records:
                end = torch.where(rec.hit, torch.where(ok, _END_NONE, _END_DARK), _END_SKY)
                winner = torch.where(rec.hit, rec.sphere_index, -1)
                records.append((live, _record_rows(o, d, att, winner, k, i, end)))
            if last:
                break
            keep = (rec.hit & ok).nonzero()[:, 0]
            if keep.numel() == 0:
                break
            live = live[keep]
            o, d, att = rec.point[keep], new_dir[keep], (att * mat_att)[keep]
            k = (k[0][keep], k[1][keep])
        out = (rad,) + ((work,) if return_work else ()) + ((records,) if return_records else ())
        return out if len(out) > 1 else rad


def ray_color(scene: Scene, origin: torch.Tensor, direction: torch.Tensor, keys,
              max_depth: int = 50) -> torch.Tensor:
    """Single-name alias of `trace_rays_threefry` mirroring the reference's
    `ray_color` (reference: src/gpu/camera.h:112-138), as the JAX package's
    `ray_color` (ops/integrator.py:123-132) aliases its keyed `trace_rays`:
    [R] per-ray keys, rays [R, 3] -> radiance [R, 3]."""
    return trace_rays_threefry(scene, origin, direction, keys, max_depth)
