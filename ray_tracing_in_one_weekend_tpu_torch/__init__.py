"""Path tracer on PyTorch with a hand-written CUDA kernel for Hopper.

The port of `ray_tracing_in_one_weekend_tpu` (JAX/Pallas on a TPU) to
PyTorch on an NVIDIA H100; the JAX package is its reference. This slice
is the forward render of the cover scene: scene and camera
(`models/`), the render kernel and its plain PyTorch version
(`ops/cuda_render.py`, `csrc/`, `kernels/`), 8-bit output and PPM
(`ops/image.py`, `utils/ppm.py`), and the CLI (`utils/cli.py`).

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
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda
from ray_tracing_in_one_weekend_tpu_torch.utils.config import RenderConfig

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
    "RenderConfig",
]
