"""Progressive rendering with checkpoint/resume.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/checkpoint.py.
The reference has no checkpointing; its closest analogue is merging
partial renders offline (reference: gallery/gpu/image11-source-images/).
Here the framebuffer accumulates per-sample sums plus a sample counter,
and is serializable at any point.

Every sample draws from a stream keyed by the GLOBAL (pixel, sample)
index (`render_cuda`'s `sample_offset`), so rendering samples [k, k+n)
after a checkpoint at k draws the samples one k+n-sample run would have
drawn. The accumulated mean equals the monolithic mean up to float
summation order: each batch boundary re-associates the per-sample sum.

Two backends, as the CLI names them. `cuda` (and `torch`, the same on a
CPU scene) renders the port's PCG streams through `render_cuda`, the
kernel on the card and its plain version on the CPU. `jnp` renders the
JAX package's jnp backend on threefry keys (`ops/cuda_threefry.py`:
`csrc/threefry_render_kernel.cu` on the card, the plain functions of
`ops/render.py` on the CPU), as the JAX `accumulate` does by default.

Files are `np.savez_compressed` archives with the JAX package's keys
(`accum`, `spp_done`, `work`), so a checkpoint written by one package
resumes in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene, resolve_device
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    DEFAULT_TILE,
    render_cuda,
    render_cuda_distributed,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.render import DEFAULT_CHUNK, render_keyed
from ray_tracing_in_one_weekend_tpu_torch.utils.spans import spanned, sync


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Accumulated render progress.

    `work` is the latest batch's per-pixel cost map (None until the first
    batch). It is kept for diagnostics and as an explicit `work_hint`
    after a resume; the batches themselves schedule through the
    renderer's own warm-start cache."""

    accum: torch.Tensor  # [H, W, 3] float32 sum of per-sample radiance
    spp_done: int  # samples accumulated so far
    work: torch.Tensor | None = None  # [H, W] float32 cost map

    @property
    def image(self) -> torch.Tensor:
        """Current linear framebuffer estimate [H, W, 3]."""
        return self.accum / float(max(self.spp_done, 1))


def new_state(cam: Camera, device="cuda") -> RenderState:
    device = resolve_device(device)
    return RenderState(
        accum=torch.zeros((cam.image_height, cam.image_width, 3), dtype=torch.float32, device=device),
        spp_done=0,
    )


@spanned("rt.accumulate")
def accumulate(
    state: RenderState,
    scene: Scene,
    cam: Camera,
    seed: int,
    spp_batch: int,
    tile: int = DEFAULT_TILE,
    warm: bool = True,
    mesh=None,
    backend: str = "cuda",
    chunk_size: int = DEFAULT_CHUNK,
) -> RenderState:
    """Render the next `spp_batch` samples and fold them into `state`.

    Sample indices continue from `state.spp_done`, so any batching
    schedule yields the same final image as one monolithic run (to float
    summation order). The render runs on the scene's device: the kernel
    on the card, the plain version on the CPU. A state on another device
    raises; nothing is moved.

    Each batch renders a new sample window, so it misses the warm-start
    cache and runs the cold schedule; with `warm` it refills the entry
    all the same, as the JAX package's `accumulate` does.

    With a `mesh` (`parallel/dist.py`) the batch renders sharded over it
    (`render_cuda_distributed`), as the JAX package's does over its mesh,
    and every rank folds the same whole image into its state: the batch
    must divide evenly over the sample axis.

    `backend="jnp"` renders the batch on threefry keys from `seed` (the
    JAX package's jnp `accumulate`, checkpoint.py:68-165): the plain path
    `chunk_size` pixels at a time on the CPU, the kernel on the card,
    `parallel.dist.render_distributed` on a mesh; the state keeps its
    `work` map. `tile` and `warm` belong to the PCG backends.
    """
    if state.accum.device != scene.device:
        raise ValueError(f"the render state is on {state.accum.device} and the scene on "
                         f"{scene.device}; build both on one device")
    if backend == "jnp":
        if mesh is not None:
            from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import render_distributed

            colors = render_distributed(scene, cam, seed, mesh, chunk_size=chunk_size, spp=spp_batch,
                                        sample_offset=state.spp_done)
        else:
            pix = torch.arange(cam.num_pixels, device=scene.device)
            colors = render_keyed(scene, cam, pix, seed, spp_batch, state.spp_done, chunk_size).reshape(
                cam.image_height, cam.image_width, 3)
        return RenderState(accum=state.accum + colors * float(spp_batch),
                           spp_done=state.spp_done + spp_batch, work=state.work)
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: cuda, torch or jnp")
    kw = dict(seed=seed, tile=tile, spp=spp_batch, sample_offset=state.spp_done,
              return_work=True, warm=warm)
    if mesh is not None:
        colors, work = render_cuda_distributed(scene, cam, mesh=mesh, **kw)
    else:
        colors, work = render_cuda(scene, cam, **kw)
    # Two operations, as the JAX package's fold rounds them: one fused
    # multiply-add would change the bits.
    return RenderState(
        accum=state.accum + colors * float(spp_batch),
        spp_done=state.spp_done + spp_batch,
        work=work,
    )


def save(state: RenderState, path: str) -> None:
    with sync("checkpoint_save"):
        arrays = dict(
            accum=state.accum.cpu().numpy(),
            spp_done=np.asarray(state.spp_done, np.int32),
        )
        if state.work is not None:
            arrays["work"] = state.work.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load(path: str, device="cuda") -> RenderState:
    device = resolve_device(device)
    with np.load(path) as z:
        return RenderState(
            accum=torch.tensor(z["accum"], dtype=torch.float32, device=device),
            spp_done=int(z["spp_done"]),
            work=torch.tensor(z["work"], dtype=torch.float32, device=device) if "work" in z.files else None,
        )
