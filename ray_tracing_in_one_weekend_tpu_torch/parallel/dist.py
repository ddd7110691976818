"""Pixel x sample sharding over torch.distributed, one process per rank.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/parallel/dist.py.
The JAX package shards over a `jax.sharding.Mesh` of devices inside one
program; here every rank of a `(P, S)` mesh is a process of its own
(torchrun, or `parallel/worker.py`), and rank r holds pixel coordinate
r // S and sample coordinate r % S.

* **pixel axis** (`'pixels'`): the flat pixel space is split into P
  contiguous, tile-aligned slabs of `shard_pixels = ceil(n / (P·tile))·tile`
  pixels (ops/pallas_render.py:1365). A slab may lie partly or wholly past
  the image: its lanes are born finished.
* **sample axis** (`'samples'`): rank s of a pixel group renders the sample
  window [offset + s·spp/S, offset + (s+1)·spp/S), and the group's images
  are averaged.

Every random draw keys on GLOBAL (pixel, sample) ids, so a pixel mesh gives
one device's image bit for bit, and a sample mesh gives the windows rendered
on one device and averaged in rank order.

The jnp backend on threefry keys (`render_distributed`,
`render_image_distributed`, parallel/dist.py:96-179 there) splits pixels as
the JAX package does: P equal contiguous slabs of ceil(n / P) pixels, the
padding repeating the last pixel, each rendered by `render_keyed` (the
kernel on the card, the plain version on the CPU). Its gradient, JAX's
`render_loss`, `render_grads` and `train_step` (:225-282 there), goes
through `render_distributed(..., differentiable=True)`: on a CUDA scene the
forward records its paths (`ops/cuda_threefry.record_keyed`) and the
backward reverses them (`keyed_grad_pass`), on a CPU scene torch.autograd
through the plain render, re-rendered a chunk at a time. `render_grads_autograd` takes the plain route on any device: the
oracle the card holds the kernels against. The PCG streams' autograd
render keeps its own names, `render_loss_pcg`, `render_grads_pcg` and
`train_step_pcg`.

The collectives are the two fixed-order ones below, written once: a sum over
a group that all-gathers the ranks' tensors and adds them in rank order
(every rank holds the same bits whatever the backend: a backend's own
`all_reduce` may add in any order, and NCCL and gloo differ), and an
all-gather of the pixel slabs into the image. gloo carries CUDA tensors
for only some collectives, so under gloo a CUDA operand is copied to the
host for the exchange and back; the render itself stays on the card.

NCCL refuses two ranks on one GPU, so ranks that share a card use gloo
(`init_distributed` picks it).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import (
    DIFF_FIELDS,
    scene_params,
    scene_with_params,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import _rank_share, pack_camera, pack_scene
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_threefry import keyed_grad_pass, record_keyed
from ray_tracing_in_one_weekend_tpu_torch.ops.render import (
    DEFAULT_CHUNK,
    render_flat_threefry,
    render_keyed,
    render_lanes,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.threefry import as_key

PIXEL_AXIS = "pixels"
SAMPLE_AXIS = "samples"

__all__ = [
    "PIXEL_AXIS", "SAMPLE_AXIS", "DIFF_FIELDS", "Mesh", "make_mesh", "init_distributed",
    "fetch_image", "sum_in_order", "gather_in_order", "scene_params", "scene_with_params",
    "render_loss", "render_grads", "render_grads_autograd", "train_step", "render_loss_pcg",
    "render_grads_pcg", "train_step_pcg", "render_distributed", "render_image_distributed",
]


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (same shape and dtype on every rank), in group-rank
    order, on `t`'s device."""
    src = t.detach().contiguous()
    on_host = src.device.type == "cuda" and dist.get_backend(group) != "nccl"
    if on_host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if on_host else parts


def sum_in_order(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `t` over `group`, ((t0 + t1) + t2) + ... in
    group-rank order: the same bits on every rank and under any backend.
    With no group (one rank) it is `t` itself."""
    if group is None:
        return t
    parts = _all_gather(t, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_in_order(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` over `group` joined along the last dimension in
    group-rank order (the pixel slabs into the image)."""
    if group is None:
        return t
    return torch.cat(_all_gather(t, group), dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('pixels', 'samples') mesh of `pixels` x `samples` ranks, seen from
    rank `rank`. `sample_group` holds the S ranks that share this rank's
    pixel slab, `pixel_group` the P ranks that share its sample window,
    `world` all of them; each is None when it would hold one rank.
    `seconds["collectives"]` adds up the wall time spent in this mesh's
    collectives (each starts and ends with a synchronize of the operand's
    device, so the time is the exchange's own)."""

    pixels: int
    samples: int
    rank: int = 0
    sample_group: object = None
    pixel_group: object = None
    world: object = None
    seconds: dict = dataclasses.field(default_factory=lambda: {"collectives": 0.0})

    @property
    def shape(self) -> dict:
        return {PIXEL_AXIS: self.pixels, SAMPLE_AXIS: self.samples}

    @property
    def pixel_index(self) -> int:
        return self.rank // self.samples

    @property
    def sample_index(self) -> int:
        return self.rank % self.samples

    def _timed(self, fn, t, group):
        if group is None:
            return fn(t, group)
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn(t, group)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        self.seconds["collectives"] += time.perf_counter() - t0
        return out

    def sample_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of `t` over this rank's pixel group: the rank-order sum
        divided by S."""
        return self._timed(sum_in_order, t, self.sample_group) / self.samples

    def gather_pixels(self, t: torch.Tensor) -> torch.Tensor:
        """The P slabs [..., shard_pixels] -> [..., P * shard_pixels]."""
        return self._timed(gather_in_order, t, self.pixel_group)

    def sum_all(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over every rank of the mesh, in rank order."""
        return self._timed(sum_in_order, t, self.world)

    def barrier(self) -> None:
        if self.world is not None:
            dist.barrier(group=self.world)

    def build_kernels(self, device) -> None:
        """On the card, rank 0 builds the kernels of `csrc/` before the others
        load them (the build is atomic, but concurrent nvcc runs are waste)."""
        if torch.device(device).type != "cuda":
            return
        if self.rank == 0:
            from ray_tracing_in_one_weekend_tpu_torch.kernels import build

            build.build()
        self.barrier()


def make_mesh(mesh_shape: tuple | None = None) -> Mesh:
    """Build a ('pixels', 'samples') mesh over the default process group.

    `mesh_shape=(P,)` shards pixels only; `(P, S)` also shards the sample
    budget S ways. Default: every rank on the pixel axis. Without a process
    group there is one rank. The mesh must cover every rank of the group:
    each rank is a process, and a rank outside the mesh would have nothing
    to run. Every rank must call this with the same shape, in the same
    order with respect to other calls that create process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if mesh_shape is None or len(mesh_shape) == 0:
        mesh_shape = (world,)
    if len(mesh_shape) == 1:
        mesh_shape = (mesh_shape[0], 1)
    if len(mesh_shape) != 2:
        raise ValueError(f"mesh_shape must be (P,) or (P, S), got {mesh_shape}")
    n_pix, n_smp = (int(v) for v in mesh_shape)
    if n_pix < 1 or n_smp < 1:
        raise ValueError(f"mesh_shape {mesh_shape} must be positive")
    n = n_pix * n_smp
    if n > world:
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {mesh_shape} covers {n} of the {world} ranks; each rank is a "
                         f"process, so the mesh must cover all of them")
    sample_group = pixel_group = None
    if n_smp > 1:
        for p in range(n_pix):  # every rank creates every group, in one order
            g = dist.new_group([p * n_smp + s for s in range(n_smp)])
            if p == rank // n_smp:
                sample_group = g
    if n_pix > 1:
        for s in range(n_smp):
            g = dist.new_group([p * n_smp + s for p in range(n_pix)])
            if s == rank % n_smp:
                pixel_group = g
    return Mesh(n_pix, n_smp, rank, sample_group, pixel_group,
                dist.group.WORLD if world > 1 else None)


def _default_backend(local_ranks: int) -> tuple[str, str]:
    """(backend, why): nccl when every rank of this host has a GPU of its
    own, gloo when ranks share a card or there is none."""
    if not torch.cuda.is_available():
        return "gloo", "no GPU"
    n_gpus = torch.cuda.device_count()
    if local_ranks > n_gpus:
        return "gloo", f"{local_ranks} ranks share {n_gpus} GPU(s), and NCCL needs one GPU a rank"
    return "nccl", f"{local_ranks} rank(s) on {n_gpus} GPU(s)"


# How long a rank waits in a collective for the others before it raises.
COLLECTIVE_TIMEOUT_S = 600.0


def init_distributed(backend: str | None = None, coordinator: str | None = None,
                     num_processes: int | None = None, process_id: int | None = None) -> None:
    """Join the process group of a multi-rank run.

    Without `coordinator` it reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT; with it (HOST:PORT) it
    takes `num_processes` and `process_id` as given. The rank's GPU, if
    there is one, becomes LOCAL_RANK % device_count. The backend defaults
    to nccl when every rank of this host has a GPU of its own and to gloo
    otherwise; the choice is printed on stderr, and an explicit `backend`
    always wins. gloo carries only the collectives: the render stays on
    the card."""
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
        init_method = f"tcp://{coordinator}"
    else:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("init_distributed: RANK and WORLD_SIZE are not set (run under "
                               "torchrun, or pass coordinator, num_processes and process_id)")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init_method = "env://"
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend, why = _default_backend(local_ranks)
    else:
        why = "asked for"
    print(f"init_distributed: rank {rank} of {world}, backend {backend} ({why})",
          file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _padded_pixel_count(n_pixels: int, n_shards: int) -> int:
    """Pixels padded so every slab gets the same whole number of pixels
    (JAX parallel/dist.py:90-93)."""
    return -(-n_pixels // n_shards) * n_shards


def render_distributed(scene: Scene, cam: Camera, base_key=0, mesh: Mesh | None = None,
                       chunk_size: int = DEFAULT_CHUNK, spp: int | None = None,
                       differentiable: bool = False, sample_offset: int = 0) -> torch.Tensor:
    """The jnp backend's image sharded over `mesh` (default: every rank on
    the pixel axis) -> linear [H, W, 3], the whole image on every rank, on
    the scene's device (JAX parallel/dist.py:96-161).

    Rank (p, s) renders pixel slab p, global ids [p·slab, (p+1)·slab) with
    slab = ceil(n / P) (ids past the image repeat the last pixel and are
    cut after the gather), and the sample window s: global samples
    [sample_offset + s·spp/S, sample_offset + (s+1)·spp/S). The windows
    are averaged over the sample axis in rank order (`sum_in_order`, then
    / S) and the slabs gathered in rank order. A pixel mesh gives
    `render_image`'s bits; a sample mesh the windows rendered on one device
    and averaged in rank order. `spp % S != 0` raises.

    With `differentiable=True` the image is the same bits, with a gradient
    to the scene's center, radius, albedo, fuzz and ior (those that require
    it): `_DiffRenderKeyed`."""
    mesh = make_mesh() if mesh is None else mesh
    if differentiable:
        return _keyed_image(scene, cam, base_key, mesh, chunk_size, spp, sample_offset, plain=False)
    share = _keyed_share(cam, base_key, mesh, chunk_size, spp, sample_offset, plain=False)
    idx = _slab_ids(share, scene.device)
    colors = render_keyed(scene, cam, idx, share.key, share.spp, share.sample_offset, chunk_size)
    rad = mesh.gather_pixels(mesh.sample_mean(colors.T.contiguous()))
    return rad[:, : share.n_pixels].T.reshape(cam.image_height, cam.image_width, 3)


def render_image_distributed(scene: Scene, cam: Camera, base_key=0, mesh: Mesh | None = None,
                             chunk_size: int = DEFAULT_CHUNK, spp: int | None = None) -> torch.Tensor:
    """End-user entry of the sharded jnp backend (JAX parallel/dist.py:164-179):
    `render_distributed` from sample 0."""
    return render_distributed(scene, cam, base_key, mesh, chunk_size, spp)


def fetch_image(img: torch.Tensor) -> np.ndarray:
    """The whole image as a numpy array. The sharded renders return the
    gathered image on every rank, so this is a copy to the host."""
    return img.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Differentiable rendering through torch.autograd on the PCG streams.
#
# `render_loss_pcg`, `render_grads_pcg` and `train_step_pcg`: the JAX
# package's jnp `render_loss`, `render_grads` and `train_step`
# (parallel/dist.py:225-282) on the port's PCG streams, the plain render of
# `ops/render.py` under torch.autograd, a gradient independent of the PCG
# backward kernels (`ops/cuda_grad.py`): their oracle. It launches no
# kernel. Pixel slabs split the flat pixel space into P equal contiguous
# parts of ceil(n / P) pixels (parallel/dist.py:90-93 there), and the
# sample axis splits spp into S windows.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Share:
    start: int  # this rank's first global pixel
    stop: int  # one past its last pixel inside the image
    slab: int  # pixels a slab, ceil(n / P)
    n_pixels: int
    seed: int
    spp: int  # this rank's samples, spp / S
    samples: int  # S
    sample_offset: int  # this rank's window starts here
    max_depth: int
    chunk_size: int


class _AutogradRender(torch.autograd.Function):
    """(p_mat, cam_vec) -> the image's radiance [3, n] on every rank, whose
    vector-Jacobian product re-renders the rank's pixels under autograd one
    chunk at a time.

    Forward: the rank's slab and sample window without the tape, then the
    windows' rank-order mean and the slabs' gather, as `render_with` does.
    Backward: every rank holds the whole image's cotangent; it takes its
    slab's part (each window enters the image with weight 1 / S),
    re-renders each chunk with gradient and backpropagates it, so memory
    is one chunk's tape, and sums the [16, N] cotangent over the mesh in
    rank order (`Mesh.sum_all`), so every rank gets the same bits and the
    chain rule through `pack_scene` runs once, on the sum."""

    @staticmethod
    def forward(ctx, p_mat, cam_vec, share: _Share, mesh):
        pix = torch.arange(share.start, share.stop, device=p_mat.device)
        rad = render_lanes(p_mat, cam_vec, pix, share.seed, share.spp, share.sample_offset,
                           share.max_depth, share.chunk_size)
        if mesh is not None:
            slab = torch.zeros(3, share.slab, dtype=rad.dtype, device=rad.device)
            slab[:, : rad.shape[1]] = rad
            rad = mesh.gather_pixels(mesh.sample_mean(slab))[:, : share.n_pixels].contiguous()
        ctx.save_for_backward(p_mat, cam_vec)
        ctx.share, ctx.mesh = share, mesh
        return rad

    @staticmethod
    def backward(ctx, grad_rad):
        p_mat, cam_vec = ctx.saved_tensors
        share, mesh = ctx.share, ctx.mesh
        grads = torch.zeros_like(p_mat)
        g = grad_rad[:, share.start : share.stop] / share.samples
        pix = torch.arange(share.start, share.stop, device=p_mat.device)
        with torch.enable_grad():
            leaf = p_mat.detach().requires_grad_()
            for a in range(0, pix.numel(), share.chunk_size):
                rad = render_lanes(leaf, cam_vec, pix[a : a + share.chunk_size], share.seed,
                                   share.spp, share.sample_offset, share.max_depth,
                                   share.chunk_size, differentiable=True)
                if rad.grad_fn is None:  # every ray of the chunk went to the sky at once
                    continue
                (part,) = torch.autograd.grad(rad, leaf, grad_outputs=g[:, a : a + share.chunk_size])
                grads = grads + part
        if mesh is not None:
            grads = mesh.sum_all(grads)
        return grads, None, None, None


def render_loss_pcg(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, seed: int = 0,
                    mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK,
                    spp: int | None = None) -> torch.Tensor:
    """Mean squared pixel error of the render of `scene` with `params`
    against `target` [H, W, 3], differentiable in `params` by
    torch.autograd; on `mesh` the render is sharded over it and the loss is
    the whole image's, on every rank (mesh=None: one process). The image is
    `render_cuda`'s bits (on a sample mesh, its windows' rank-order mean),
    so the loss is `render_loss_cuda`'s."""
    spp = cam.samples_per_pixel if spp is None else spp
    n = cam.num_pixels
    start, slab, spp_local, window = _rank_share(n, 1, spp, 0, mesh)
    share = _Share(start=min(start, n), stop=min(start + slab, n), slab=slab, n_pixels=n,
                   seed=seed, spp=spp_local, samples=spp // spp_local, sample_offset=window,
                   max_depth=cam.max_depth, chunk_size=chunk_size)
    scene = scene_with_params(scene, params)
    rad = _AutogradRender.apply(pack_scene(scene), pack_camera(cam).to(scene.device), share, mesh)
    img = rad.T.reshape(cam.image_height, cam.image_width, 3)
    return torch.mean((img - target) ** 2)


def render_grads_pcg(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, seed: int = 0,
                     mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK,
                     spp: int | None = None):
    """(loss, grads) of `render_loss_pcg` with respect to `params`, one
    gradient per field, by torch.autograd through the plain render; on a
    mesh the same bits on every rank."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = render_loss_pcg(leaves, scene, cam, target, seed, mesh, chunk_size, spp)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.detach(), grads


def train_step_pcg(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, seed: int = 0,
                   mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK,
                   spp: int | None = None, lr: float = 1e-2):
    """One SGD step of inverse rendering -> (loss, new_params): the
    autograd render's forward, its chunked backward, the cross-rank sum of
    the gradient, and the update."""
    loss, grads = render_grads_pcg(params, scene, cam, target, seed, mesh, chunk_size, spp)
    return loss, {k: (params[k] - lr * grads[k]).detach() for k in params}


# ---------------------------------------------------------------------------
# The keyed gradient: the JAX package's `render_loss`, `render_grads` and
# `train_step` (parallel/dist.py:225-282) on its threefry keys.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _KeyedShare:
    start: int  # this rank's first global pixel
    stop: int  # one past its last pixel inside the image
    slab: int  # pixels a slab, ceil(n / P)
    n_pixels: int
    key: tuple  # the base key's words
    spp: int  # this rank's samples, spp / S
    samples: int  # S
    sample_offset: int  # this rank's window starts here
    chunk_size: int
    plain: bool  # the plain functions on any device (the oracle)


def _keyed_share(cam: Camera, base_key, mesh: Mesh, chunk_size, spp, sample_offset, plain) -> _KeyedShare:
    spp = cam.samples_per_pixel if spp is None else spp
    if spp % mesh.samples != 0:
        raise ValueError(f"samples_per_pixel={spp} must divide evenly over the '{SAMPLE_AXIS}' mesh "
                         f"axis of size {mesh.samples}")
    spp_local = spp // mesh.samples
    n = cam.num_pixels
    slab = _padded_pixel_count(n, mesh.pixels) // mesh.pixels
    start = mesh.pixel_index * slab
    return _KeyedShare(start=start, stop=min(start + slab, n), slab=slab, n_pixels=n, key=as_key(base_key),
                       spp=spp_local, samples=mesh.samples,
                       sample_offset=sample_offset + mesh.sample_index * spp_local, chunk_size=chunk_size,
                       plain=plain)


def _slab_ids(share: _KeyedShare, device) -> torch.Tensor:
    """The slab's global pixel ids; those past the image repeat the last."""
    return torch.clamp(torch.arange(share.start, share.start + share.slab, device=device), max=share.n_pixels - 1)


def _scene_from_packed(p_mat: torch.Tensor, scene: Scene) -> Scene:
    """The scene whose center, radius, albedo, fuzz and ior are views of the
    packed matrix's rows (0-3, 5-9), so gradients reach those rows. An
    active sphere's values are the scene's bits; an inactive one's center is
    0, which no sweep sees."""
    return scene.replace(center=p_mat[0:3].T, radius=p_mat[3], albedo=p_mat[5:8].T, fuzz=p_mat[8],
                         ior=p_mat[9])


def _autograd_slab(p_mat, scene: Scene, cam: Camera, pix, g, share: _KeyedShare) -> torch.Tensor:
    """[16, N] cotangent of `p_mat` for the radiance cotangent `g` [3, R] of
    global pixels `pix` [R]: the plain render re-rendered `chunk_size`
    pixels at a time under torch.autograd (memory is one chunk's tape)."""
    grads = torch.zeros_like(p_mat)
    with torch.enable_grad():
        leaf = p_mat.detach().requires_grad_()
        sc = _scene_from_packed(leaf, scene)
        for a in range(0, pix.numel(), share.chunk_size):
            colors = render_flat_threefry(sc, cam, pix[a : a + share.chunk_size], share.key,
                                          chunk_size=share.chunk_size, spp=share.spp,
                                          sample_offset=share.sample_offset, differentiable=True)
            if colors.grad_fn is None:  # every ray of the chunk went to the sky at once
                continue
            (part,) = torch.autograd.grad(colors, leaf, grad_outputs=g[:, a : a + share.chunk_size].T,
                                          allow_unused=True)
            if part is not None:
                grads = grads + part
    return grads


class _DiffRenderKeyed(torch.autograd.Function):
    """(p_mat, ...) -> the keyed image's radiance [3, n] on every rank, whose
    vector-Jacobian product is the keyed backward.

    Forward: the rank's slab and sample window, the windows' rank-order mean
    and the slabs' gather, as `render_distributed` does: on a CUDA scene,
    when a backward can follow, `record_keyed` over the slab's pixels
    inside the image (`threefry_record_kernel`: the forward's bits, and its
    paths recorded for the backward; the pixels past the image repeat the
    last one's color), else `threefry_render_kernel`; on a CPU scene, or
    with `share.plain`, `render_flat_threefry` without a tape. Backward:
    every rank holds the whole image's cotangent; it takes its slab's
    pixels inside the image (each window enters the image with weight 1 /
    S, each sample its window with 1 / spp) and gets the [16, N] cotangent
    of the packed scene from `keyed_grad_pass` on the recorded paths (the
    reverse kernel and the reduction) on the card, or by re-rendering the
    slab under autograd one chunk at a time (the recording goes with the
    first backward; a second one through a retained graph records the same
    paths again); then sums it over the mesh in rank order (`Mesh.sum_all`), so every rank gets the same bits and the
    chain rule through `pack_scene` runs once, on the sum."""

    @staticmethod
    def forward(ctx, p_mat, scene: Scene, cam: Camera, share: _KeyedShare, mesh):
        idx = _slab_ids(share, p_mat.device)
        n_live = share.stop - share.start
        rec = None
        if share.plain or scene.device.type != "cuda":
            colors = render_flat_threefry(scene, cam, idx, share.key, chunk_size=share.chunk_size, spp=share.spp,
                                          sample_offset=share.sample_offset)
        elif ctx.needs_input_grad[0] and n_live > 0:
            colors, _, rec = record_keyed(scene, cam, idx[:n_live], share.key, share.spp, share.sample_offset,
                                          p_mat)
            colors = torch.cat([colors, colors[-1:].expand(idx.numel() - n_live, 3)])
        else:
            colors = render_keyed(scene, cam, idx, share.key, share.spp, share.sample_offset, share.chunk_size)
        rad = mesh.gather_pixels(mesh.sample_mean(colors.T.contiguous()))[:, : share.n_pixels].contiguous()
        ctx.save_for_backward(p_mat)
        ctx.scene, ctx.cam, ctx.share, ctx.mesh, ctx.rec = scene, cam, share, mesh, rec
        return rad

    @staticmethod
    def backward(ctx, grad_rad):
        (p_mat,) = ctx.saved_tensors
        share, mesh = ctx.share, ctx.mesh
        rec, ctx.rec = ctx.rec, None  # the arena goes with this call
        n_live = share.stop - share.start
        if n_live <= 0 or grad_rad is None:
            grads = torch.zeros_like(p_mat)  # a slab wholly past the image: no launch
        else:
            g = grad_rad[:, share.start : share.stop] / share.samples
            pix = torch.arange(share.start, share.stop, device=p_mat.device)
            if share.plain or ctx.scene.device.type != "cuda":
                grads = _autograd_slab(p_mat, ctx.scene, ctx.cam, pix, g, share)
            else:
                if rec is None:  # a second backward through a retained graph: record the same paths again
                    _, _, rec = record_keyed(ctx.scene, ctx.cam, pix, share.key, share.spp, share.sample_offset,
                                             p_mat)
                grads = keyed_grad_pass(rec, g / share.spp, share.start, share.stop)
        return mesh.sum_all(grads), None, None, None, None


def _keyed_image(scene: Scene, cam: Camera, base_key, mesh: Mesh, chunk_size, spp, sample_offset,
                 plain: bool) -> torch.Tensor:
    share = _keyed_share(cam, base_key, mesh, chunk_size, spp, sample_offset, plain)
    frozen = Scene(**{f.name: getattr(scene, f.name).detach() for f in dataclasses.fields(scene)})
    rad = _DiffRenderKeyed.apply(pack_scene(scene), frozen, cam, share, mesh)
    return rad.T.reshape(cam.image_height, cam.image_width, 3)


def render_loss(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, base_key=0,
                mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK,
                spp: int | None = None) -> torch.Tensor:
    """Mean squared pixel error of the keyed render of `scene` with `params`
    against `target` [H, W, 3] (JAX parallel/dist.py:225-241):
    `render_distributed(..., differentiable=True)` on `base_key` (an int
    seed or a key) over `mesh` (default: every rank on the pixel axis), the
    whole image's loss on every rank. The image is `render_image`'s bits
    (on a sample mesh, its windows' rank-order mean)."""
    img = render_distributed(scene_with_params(scene, params), cam, base_key, mesh, chunk_size, spp,
                             differentiable=True)
    return torch.mean((img - target) ** 2)


def _loss_and_grads(loss_fn, params: dict, *args):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, *args)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.detach(), grads


def render_grads(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, base_key=0,
                 mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK, spp: int | None = None):
    """(loss, grads) of `render_loss` with respect to `params`, one gradient
    per field (JAX parallel/dist.py:244-258): on a CUDA scene the forward
    kernel and the keyed backward kernels, which raise if they cannot build
    or launch; on a CPU scene torch.autograd through the plain render. On a
    mesh, the same bits on every rank."""
    return _loss_and_grads(render_loss, params, scene, cam, target, base_key, mesh, chunk_size, spp)


def _render_loss_autograd(params, scene, cam, target, base_key, mesh, chunk_size, spp):
    mesh = make_mesh() if mesh is None else mesh
    img = _keyed_image(scene_with_params(scene, params), cam, base_key, mesh, chunk_size, spp, 0, plain=True)
    return torch.mean((img - target) ** 2)


def render_grads_autograd(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, base_key=0,
                          mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK,
                          spp: int | None = None):
    """`render_grads` by torch.autograd through the plain functions on
    whatever device the scene is on: the forward `render_flat_threefry`
    without a tape, the backward the slab re-rendered `chunk_size` pixels
    at a time under autograd. It launches no kernel: the oracle the card
    holds the keyed kernels against, and their whole path's plain version."""
    return _loss_and_grads(_render_loss_autograd, params, scene, cam, target, base_key, mesh, chunk_size, spp)


def train_step(params: dict, scene: Scene, cam: Camera, target: torch.Tensor, base_key=0,
               mesh: Mesh | None = None, chunk_size: int = DEFAULT_CHUNK, spp: int | None = None,
               lr: float = 1e-2):
    """One SGD step of inverse rendering on the keyed render -> (loss,
    new_params) (JAX parallel/dist.py:261-282): the sharded forward, the
    backward, the cross-rank sum of the gradient, and the update."""
    loss, grads = render_grads(params, scene, cam, target, base_key, mesh, chunk_size, spp)
    return loss, {k: (params[k] - lr * grads[k]).detach() for k in params}
