"""Render configuration and the reference's workload presets.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/config.py:
the same fields, defaults and presets, with the backends of the port:
`cuda` (the default: the hand-written kernel on the GPU), `torch`
(its plain PyTorch version on the CPU, only when asked for) and `jnp`
(the JAX package's jnp backend on threefry keys: the hand-written
`threefry_render_kernel` on the GPU, or its plain version on the CPU
with `--platform cpu`). The reference has no config/flag system —
every parameter is a compile-time constant
(reference: src/cpu/main.cc:82-99, src/gpu/camera.h:58-71,
src/gpu-old/main.cu:145-152).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ray_tracing_in_one_weekend_tpu_torch.ops.render import DEFAULT_CHUNK

BACKENDS = ("cuda", "torch", "jnp")
PLATFORMS = ("auto", "cpu", "gpu")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image (reference: src/cpu/main.cc:82-86; src/gpu/camera.h:58-63)
    image_width: int = 1200
    aspect_ratio: float = 3.0 / 2.0
    samples_per_pixel: int = 10
    max_depth: int = 50

    # Camera (reference: src/gpu/camera.h:65-71; src/cpu/main.cc:93-99)
    vfov_degrees: float = 20.0
    lookfrom: Tuple[float, float, float] = (13.0, 2.0, 3.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle_degrees: float = 0.6
    focus_dist: float = 10.0
    # CPU-tree lens parameterization (lens_radius = aperture/2,
    # reference: src/cpu/camera.h:20-26); takes precedence when set.
    aperture: float | None = None

    seed: int = 0
    scene: str = "cover"  # cover | three | single
    # Pixels a chunk of the jnp backend's plain path (its [chunk, N] sweep).
    chunk_pixels: int = DEFAULT_CHUNK
    backend: str = "cuda"  # cuda | torch | jnp
    # Ranks of the ('pixels', 'samples') mesh, (P,) or (P, S); () = one
    # device (parallel/dist.py).
    mesh_shape: Tuple[int, ...] = ()

    @property
    def image_height(self) -> int:
        return max(1, int(self.image_width / self.aspect_ratio))

    @property
    def rays_per_frame(self) -> int:
        """Primary rays, the Mrays/s numerator (BASELINE.md protocol)."""
        return self.image_width * self.image_height * self.samples_per_pixel


# The reference variants' hard-coded workloads (BASELINE.md table).
PRESETS = {
    # reference: src/cpu/main.cc:82-99 (lens by aperture 0.1)
    "cpu": RenderConfig(
        image_width=1200, aspect_ratio=3.0 / 2.0, samples_per_pixel=500,
        aperture=0.1,
    ),
    # reference: src/cpu-multi-threading/main.cc:84-88
    "cpu-mt": RenderConfig(image_width=3840, aspect_ratio=16.0 / 9.0, samples_per_pixel=500),
    # reference: src/gpu/camera.h:58-71
    "gpu": RenderConfig(image_width=1920, aspect_ratio=16.0 / 9.0, samples_per_pixel=500),
    # reference: src/gpu-old/main.cu:145-152
    "gpu-old": RenderConfig(image_width=300, aspect_ratio=3.0 / 2.0, samples_per_pixel=500),
    # The benchmark workload: cover scene, 1200x800, 10 spp, depth 50.
    "bench": RenderConfig(image_width=1200, aspect_ratio=3.0 / 2.0, samples_per_pixel=10),
}


def make_camera_from_config(config: RenderConfig, device="cuda"):
    from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera

    return make_camera(
        image_width=config.image_width,
        aspect_ratio=config.aspect_ratio,
        samples_per_pixel=config.samples_per_pixel,
        max_depth=config.max_depth,
        vfov_degrees=config.vfov_degrees,
        lookfrom=config.lookfrom,
        lookat=config.lookat,
        vup=config.vup,
        defocus_angle_degrees=config.defocus_angle_degrees,
        focus_dist=config.focus_dist,
        aperture=config.aperture,
        device=device,
    )


def make_scene_from_config(config: RenderConfig, device="cuda"):
    from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib

    if config.scene == "cover":
        return scene_lib.cover_scene(config.seed, device=device)
    if config.scene == "three":
        return scene_lib.three_sphere_scene(pad_to=128, device=device)
    if config.scene == "single":
        return scene_lib.single_sphere_scene(pad_to=128, device=device)
    raise ValueError(f"unknown scene {config.scene!r}")
