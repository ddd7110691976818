"""Full-image render through the plain integrators: PyTorch, differentiable.

The port's counterpart of ray_tracing_in_one_weekend_tpu/ops/render.py
(:39-138), on two kinds of streams.

On threefry keys, the JAX package's jnp backend: `render_image` (JAX's
name and signature) and under it `render_pixels_threefry`,
`render_flat_threefry` and `render_threefry`. Sample s of global pixel p
draws from key(s) = fold_in(fold_in(base, p), sample_offset + s): the
camera from fold_in(key(s), 0), the trace from fold_in(key(s), 1). The
samples add in sample order and the sum is divided by spp, as JAX's
`fori_loop` does, so any chunk size and any sample window give the same
bits. `render_keyed`, and `render_image` above it, launch
`csrc/threefry_render_kernel.cu` on a CUDA scene (`ops/cuda_threefry.py`)
and run the plain functions on a CPU scene; there is no fallback from one
to the other.

On the port's PCG streams, the same render with `differentiable=True`
(`render_pixels`, `render_flat`, `render`) instead of threefry keys. Every (pixel, sample)
ray takes its stream from the GLOBAL pixel and sample index, as
`_camera_ray_block` keys it, so any subset of pixels, any chunking and
any `sample_offset` window render the same rays. A chunk's samples are
traced side by side (one ray a lane) and then added in sample order and
scaled by 1 / spp, as the render's lanes add them (`_multipass`), so the
value is `render_cuda`'s bits, on the CPU and on the card.

This path is not a fallback and no kernel path routes to it: it launches
no kernel, and runs on the scene's device. Under autograd, gradients
reach the scene's center, radius, albedo, fuzz and ior through
`pack_scene`; the camera gets none. `parallel/dist.py` holds its loss,
gradients and train step (`render_loss_pcg`, `render_grads_pcg`,
`train_step_pcg`), whose backward re-renders one chunk at a time; the
keyed ones (`render_loss`, `render_grads`, `train_step`) differentiate
`render_flat_threefry` the same way on a CPU scene.
"""

from __future__ import annotations

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera, get_rays
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops import threefry
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import _lanes
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    _camera_ray_block,
    _unpack_cam,
    pack_camera,
    pack_scene,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_threefry import render_kernel_pixels
from ray_tracing_in_one_weekend_tpu_torch.ops.integrator import trace_rays, trace_rays_threefry
from ray_tracing_in_one_weekend_tpu_torch.utils.spans import spanned

# Default pixels per chunk (the JAX package's). A chunk traces
# chunk · spp rays at once: at the bench preset (10 spp, 512 slots) each
# [N, rays] temporary of its sweep is 335 MB on the card.
DEFAULT_CHUNK = 16384


def render_lanes(p_mat, cam_vec, pix, seed, spp, sample_offset, max_depth, chunk_size,
                 differentiable=False):
    """The sample-mean radiance [3, R] of global pixel ids `pix` [R] from
    the packed scene and camera, `chunk_size` pixels at a time: the core of
    `render_pixels` and `render_flat`, and of `parallel/dist.py`'s loss."""
    camc = _unpack_cam(cam_vec)
    t_min = float(cam_vec[20])
    pix = pix.to(torch.int64)
    parts = [
        _render_chunk(p_mat, camc, t_min, seed, pix[a : a + chunk_size], spp, sample_offset,
                      max_depth, differentiable)
        for a in range(0, pix.numel(), chunk_size)
    ]
    if not parts:
        return torch.zeros(3, 0, dtype=torch.float32, device=p_mat.device)
    return torch.cat(parts, dim=1)


def _render_chunk(p_mat, camc, t_min, seed, pix, spp, sample_offset, max_depth, differentiable):
    r = pix.numel()
    # Lane s·R + i traces sample s of pixel i.
    px, py, h0 = _lanes(camc, seed, pix.repeat(spp)[None])
    samples = torch.arange(sample_offset, sample_offset + spp, device=pix.device)
    o, d, lo, hi = _camera_ray_block(camc, h0, px, py, samples.repeat_interleave(r)[None])
    color = trace_rays(p_mat, o, d, (lo, hi), t_min, max_depth, differentiable).view(3, spp, r)
    acc = torch.zeros(3, r, dtype=torch.float32, device=pix.device)
    for s in range(spp):
        acc = acc + color[:, s]
    return acc * (1.0 / spp)


def render_pixels(
    scene: Scene,
    cam: Camera,
    pixel_indices,
    seed: int = 0,
    spp: int | None = None,
    sample_offset: int = 0,
    differentiable: bool = False,
) -> torch.Tensor:
    """Render a flat batch of global pixel indices -> linear sample-mean
    color [R, 3] on the scene's device, in one chunk. `sample_offset`
    shifts the global sample indices drawn (samples [offset, offset +
    spp)); any subset of pixels renders the same colors whichever call
    renders it."""
    return render_flat(scene, cam, pixel_indices, seed, chunk_size=None, spp=spp,
                       sample_offset=sample_offset, differentiable=differentiable)


def render_flat(
    scene: Scene,
    cam: Camera,
    pixel_indices,
    seed: int = 0,
    chunk_size: int | None = DEFAULT_CHUNK,
    spp: int | None = None,
    sample_offset: int = 0,
    differentiable: bool = False,
) -> torch.Tensor:
    """Render a flat batch of global pixel indices `chunk_size` pixels at a
    time (None: one chunk) -> [R, 3]. Without autograd, memory is one
    chunk's; under it, autograd keeps every chunk's tape until the
    backward (`parallel.dist.render_grads_pcg` keeps one)."""
    spp = cam.samples_per_pixel if spp is None else spp
    pix = torch.as_tensor(pixel_indices, device=scene.device).reshape(-1)
    chunk = max(pix.numel(), 1) if chunk_size is None else chunk_size
    if chunk < 1:
        raise ValueError(f"chunk_size ({chunk_size}) must be positive")
    rad = render_lanes(pack_scene(scene), pack_camera(cam).to(scene.device), pix, seed, spp,
                       sample_offset, cam.max_depth, chunk, differentiable)
    return rad.T


def render(
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    differentiable: bool = False,
) -> torch.Tensor:
    """Render the full image -> linear framebuffer [H, W, 3] on the scene's
    device: `render_cuda`'s value, by plain PyTorch."""
    n = cam.num_pixels
    colors = render_flat(scene, cam, torch.arange(n, device=scene.device), seed,
                         chunk_size=chunk_size, spp=spp, differentiable=differentiable)
    return colors.reshape(cam.image_height, cam.image_width, 3)


# ---------------------------------------------------------------------------
# The jnp backend on threefry keys.
# ---------------------------------------------------------------------------


def render_pixels_threefry(
    scene: Scene,
    cam: Camera,
    pixel_indices,
    base_key=0,
    spp: int | None = None,
    sample_offset: int = 0,
    differentiable: bool = False,
    return_work: bool = False,
    return_records: bool = False,
):
    """Render a flat batch of global pixel indices on threefry keys -> the
    linear sample-mean color [R, 3] on the scene's device, in one piece
    (JAX render.py:39-82), and with `return_work` the [R] int32 sweeps each
    pixel ran over its samples, as the kernel counts them. With
    `return_records`, last, every sweep as the recording forward records it:
    [(pixels [L] as positions in the batch, sample, bounce, records
    [L, 16])] (`trace_rays_threefry`'s records, sample by sample).
    `sample_offset` shifts the global sample indices drawn; any subset of
    pixels renders the same colors whichever call renders it."""
    spp = cam.samples_per_pixel if spp is None else spp
    pix = torch.as_tensor(pixel_indices, device=scene.device).reshape(-1).to(torch.int64)
    px, py = pix % cam.image_width, pix // cam.image_width
    pixel_keys = threefry.fold_in(threefry.as_key(base_key), pix)
    total = torch.zeros(pix.numel(), 3, dtype=torch.float32, device=scene.device)
    work = torch.zeros(pix.numel(), dtype=torch.int32, device=scene.device)
    records = []
    for s in range(spp):
        keys = threefry.fold_in(pixel_keys, sample_offset + s)
        origin, direction = get_rays(cam, px, py, threefry.fold_in(keys, 0))
        rad, sweeps, *recs = trace_rays_threefry(
            scene, origin, direction, threefry.fold_in(keys, 1), cam.max_depth,
            differentiable=differentiable, return_work=True, return_records=return_records,
        )
        total = total + rad
        work += sweeps
        if return_records:
            records += [(lanes, s, depth, rows) for depth, (lanes, rows) in enumerate(recs[0])]
    # A true division on every device (CUDA divides by a Python scalar as a
    # multiplication by its reciprocal), as the kernel divides.
    colors = total / torch.full_like(total, float(spp))
    out = (colors,) + ((work,) if return_work else ()) + ((records,) if return_records else ())
    return out if len(out) > 1 else colors


def render_flat_threefry(
    scene: Scene,
    cam: Camera,
    pixel_indices,
    base_key=0,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    sample_offset: int = 0,
    differentiable: bool = False,
    return_work: bool = False,
    return_records: bool = False,
):
    """`render_pixels_threefry` `chunk_size` pixels at a time -> [R, 3]
    (and, with `return_work`, the [R] sweeps a pixel; with
    `return_records`, the records, their pixels as positions in
    `pixel_indices`): memory is one chunk's [chunk, N] sweep (JAX
    render.py:85-121)."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size ({chunk_size}) must be positive")
    pix = torch.as_tensor(pixel_indices, device=scene.device).reshape(-1)
    parts = [
        render_pixels_threefry(scene, cam, pix[a : a + chunk_size], base_key, spp, sample_offset,
                               differentiable, return_work=True, return_records=return_records)
        for a in range(0, pix.numel(), chunk_size)
    ]
    colors = (torch.cat([p[0] for p in parts]) if parts
              else torch.zeros(0, 3, dtype=torch.float32, device=scene.device))
    out = (colors,)
    if return_work:
        out += (torch.cat([p[1] for p in parts]) if parts
                else torch.zeros(0, dtype=torch.int32, device=scene.device),)
    if return_records:
        out += ([(lanes + a, s, depth, rows) for a, p in zip(range(0, pix.numel(), chunk_size), parts)
                 for lanes, s, depth, rows in p[2]],)
    return out if len(out) > 1 else colors


def render_threefry(
    scene: Scene,
    cam: Camera,
    base_key=0,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    differentiable: bool = False,
) -> torch.Tensor:
    """Render the full image on threefry keys by the plain functions ->
    linear framebuffer [H, W, 3] on the scene's device."""
    colors = render_flat_threefry(scene, cam, torch.arange(cam.num_pixels, device=scene.device),
                                  base_key, chunk_size=chunk_size, spp=spp,
                                  differentiable=differentiable)
    return colors.reshape(cam.image_height, cam.image_width, 3)


@spanned("rt.keyed.render")
def render_keyed(scene: Scene, cam: Camera, pixel_indices, base_key=0, spp: int | None = None,
                 sample_offset: int = 0, chunk_size: int = DEFAULT_CHUNK, return_work: bool = False):
    """Samples [sample_offset, sample_offset + spp) of the global pixels
    `pixel_indices` on threefry keys from `base_key` -> [R, 3] means on the
    scene's device (and, with `return_work`, the [R] int32 sweeps a pixel):
    the kernel on a CUDA scene (`chunk_size` is then unused, as the kernel
    holds no [chunk, N] temporary), the plain version `chunk_size` pixels
    at a time on a CPU scene."""
    if scene.device.type == "cuda":
        return render_kernel_pixels(scene, cam, pixel_indices, base_key, spp, sample_offset,
                                    return_work=return_work)
    return render_flat_threefry(scene, cam, pixel_indices, base_key, chunk_size=chunk_size, spp=spp,
                                sample_offset=sample_offset, return_work=return_work)


def render_image(
    scene: Scene,
    cam: Camera,
    base_key=0,
    chunk_size: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """End-user entry of the jnp backend (JAX render.py:124-133): the image
    [H, W, 3] of `scene` through `cam` on threefry keys from `base_key` (an
    int seed or a key), by `render_keyed`. The same bits for any
    `chunk_size`."""
    colors = render_keyed(scene, cam, torch.arange(cam.num_pixels, device=scene.device), base_key,
                          chunk_size=chunk_size)
    return colors.reshape(cam.image_height, cam.image_width, 3)
