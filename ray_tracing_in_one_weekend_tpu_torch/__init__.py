"""Path tracer on PyTorch with a hand-written CUDA kernel for Hopper.

The port of `ray_tracing_in_one_weekend_tpu` (JAX/Pallas on a TPU) to
PyTorch on an NVIDIA H100; the JAX package is its reference. So far it
holds the forward render of the cover scene: scene and camera
(`models/`), the render kernel, its plain PyTorch version and the lane
scheduler (`ops/cuda_render.py`, `csrc/`, `kernels/`), 8-bit output and
PPM (`ops/image.py`, `utils/ppm.py`), and the CLI (`utils/cli.py`); the
gradient path: the backward render kernel, the differentiable render and
the inverse-rendering train step (`ops/cuda_grad.py`,
`examples/inverse_render.py`); the occupancy and roofline probes
with their probe kernels (`probes/`, `csrc/probe_kernels.cu`); and the
long render: progressive accumulation with checkpoints
(`utils/checkpoint.py`), batch-grain retry (`utils/resilient.py`), the
NaN guards (`utils/debug.py`) and PNG output (`utils/png.py`); and the
pixel x sample sharding of the render and the train step over
torch.distributed, one process a rank (`parallel/`), with the entry
points' multi-rank dry run (`entry.py`); and the book's milestone scenes,
cameras and shading renders (`models/milestones.py`); and the gallery:
the reference presets written as PNG with a manifest, held against the
reference's image and the TPU's renders (`scripts/`, `utils/manifest.py`);
and the differentiable render in plain PyTorch under torch.autograd, on
the same streams, with its loss, gradients and train step over a mesh
(`ops/integrator.py`, `ops/render.py`, `parallel/dist.py`
`render_loss_pcg`, `render_grads_pcg`, `train_step_pcg`): a gradient
independent of the backward kernels; and the JAX package's jnp backend on
its own threefry keys, carried bit for bit (`ops/threefry.py`,
`ops/sampling.py`, `ops/intersect.py`, `ops/materials.py`,
`render_image`, `ray_color`), with the hand-written `threefry_render_kernel` on the
card (`ops/cuda_threefry.py`, `csrc/threefry_render_kernel.cu`), sharded
by `parallel.dist.render_image_distributed` and accumulated by
`checkpoint.accumulate(backend="jnp")`; the cover scene draws from the
same keys as the JAX package's; and its gradient, JAX's `render_loss`,
`render_grads` and `train_step` on a `base_key`
(`parallel.dist.render_distributed(..., differentiable=True)`): on the
card the forward kernel and two hand-written backward kernels
(`csrc/threefry_grad_kernel.cu`: the replay records every sweep, the
reverse walks them by the keyed bounce adjoint) with the PCG backward's
reduction, on the CPU torch.autograd through the plain render;
`render_grads_autograd` is the same gradient by autograd on any device.
The keyed step runs on the CPU with `render_grads(params, scene, cam,
target, 0)` on scenes built with `device="cpu"`, and on the card on
scenes built there (the default); `examples/inverse_render.py` runs it by
default (`--backend jnp`).

Scenes and cameras are built on the card unless the caller passes
`device="cpu"`; without a GPU the default raises.

It imports torch and numpy only, never jax or flax.
"""

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera, make_camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import (
    Scene,
    cover_scene,
    cover_scene_reference,
    single_sphere_scene,
    three_sphere_scene,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import (
    render_cuda_diff,
    render_cuda_diff_distributed,
    render_grads_cuda,
    render_loss_cuda,
    train_step_cuda,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    render_cuda,
    render_cuda_distributed,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.integrator import ray_color, trace_rays, trace_rays_threefry
from ray_tracing_in_one_weekend_tpu_torch.ops.render import render, render_image
from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import (
    render_distributed,
    render_grads,
    render_grads_autograd,
    render_grads_pcg,
    render_image_distributed,
    render_loss,
    render_loss_pcg,
    train_step,
    train_step_pcg,
)
from ray_tracing_in_one_weekend_tpu_torch.utils.checkpoint import (
    RenderState,
    accumulate,
    new_state,
)
from ray_tracing_in_one_weekend_tpu_torch.utils.config import RenderConfig
from ray_tracing_in_one_weekend_tpu_torch.utils.debug import assert_finite_tree, checked_render
from ray_tracing_in_one_weekend_tpu_torch.utils.png import write_png
from ray_tracing_in_one_weekend_tpu_torch.utils.resilient import (
    BatchCorruptError,
    CheckpointCorruptError,
    RetryStats,
    accumulate_resilient,
    render_resilient,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "make_camera",
    "Scene",
    "cover_scene",
    "cover_scene_reference",
    "single_sphere_scene",
    "three_sphere_scene",
    "render_cuda",
    "render_cuda_distributed",
    "render_cuda_diff",
    "render_cuda_diff_distributed",
    "render_loss_cuda",
    "render_grads_cuda",
    "train_step_cuda",
    "trace_rays",
    "trace_rays_threefry",
    "ray_color",
    "render",
    "render_image",
    "render_distributed",
    "render_image_distributed",
    "render_loss",
    "render_grads",
    "render_grads_autograd",
    "train_step",
    "render_loss_pcg",
    "render_grads_pcg",
    "train_step_pcg",
    "RenderConfig",
    "RenderState",
    "new_state",
    "accumulate",
    "RetryStats",
    "BatchCorruptError",
    "CheckpointCorruptError",
    "accumulate_resilient",
    "render_resilient",
    "checked_render",
    "assert_finite_tree",
    "write_png",
]
