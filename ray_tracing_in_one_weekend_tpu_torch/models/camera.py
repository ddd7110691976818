"""Camera model: the derived viewport constants, on tensors.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/models/camera.py
(reference: src/gpu/camera.h:11-110). The derivation runs once on the
host in float32, in the JAX version's operation order. Ray generation on
the PCG streams lives in the render kernel
(`ops/cuda_render._camera_ray_block`); on threefry keys it is `get_rays`,
the JAX version's (and `csrc/threefry_render_kernel.cu`'s on the card).

Axis convention follows the reference GPU tree: x = column (left to
right), y = row (top to bottom), pixel (0,0) at the top-left.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.models.scene import resolve_device
from ray_tracing_in_one_weekend_tpu_torch.ops import sampling
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm

# Camera draws use this fold_in domain, disjoint from the integrator's
# per-bounce domains 0..max_depth.
CAMERA_DOMAIN = 1 << 20

_VECTORS = (
    "center",
    "pixel00_loc",
    "pixel_delta_u",
    "pixel_delta_v",
    "defocus_disk_u",
    "defocus_disk_v",
)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Derived camera constants (reference: src/gpu/camera.h:28-35,53-110)."""

    image_width: int
    image_height: int
    samples_per_pixel: int
    max_depth: int

    center: torch.Tensor  # [3] camera origin (== lookfrom)
    pixel00_loc: torch.Tensor  # [3] world-space center of pixel (0,0)
    pixel_delta_u: torch.Tensor  # [3] offset per +1 column
    pixel_delta_v: torch.Tensor  # [3] offset per +1 row (points down)
    defocus_disk_u: torch.Tensor  # [3] lens-disk horizontal basis
    defocus_disk_v: torch.Tensor  # [3] lens-disk vertical basis
    defocus_angle: torch.Tensor  # [] degrees; <= 0 disables defocus

    @property
    def num_pixels(self) -> int:
        return self.image_width * self.image_height


def make_camera(
    image_width: int = 1200,
    aspect_ratio: float = 3.0 / 2.0,
    samples_per_pixel: int = 10,
    max_depth: int = 50,
    vfov_degrees: float = 20.0,
    lookfrom=(13.0, 2.0, 3.0),
    lookat=(0.0, 0.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle_degrees: float = 0.6,
    focus_dist: float = 10.0,
    aperture: float | None = None,
    device="cuda",
) -> Camera:
    """Derive the viewport constants exactly as the reference does
    (reference: src/gpu/camera.h:53-110). Defaults are the GPU tree's
    cover-scene camera; `aperture`, when given, takes precedence over
    `defocus_angle_degrees` and reproduces the CPU tree's lens
    (lens_radius = aperture/2, reference: src/cpu/camera.h:20-26).
    """
    image_height = max(1, int(image_width / aspect_ratio))
    device = resolve_device(device)

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    lookfrom, lookat, vup = vec(lookfrom), vec(lookat), vec(vup)

    theta = math.radians(vfov_degrees)
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h * focus_dist
    viewport_width = viewport_height * (image_width / image_height)

    # Orthonormal camera frame; looking toward -w (reference: src/gpu/camera.h:84-86).
    w = vm.unit_vector(lookfrom - lookat)
    u = vm.unit_vector(vm.cross(vup, w))
    v = vm.cross(w, u)

    viewport_u = viewport_width * u  # across, left -> right
    viewport_v = viewport_height * -v  # down the image

    pixel_delta_u = viewport_u / image_width
    pixel_delta_v = viewport_v / image_height

    viewport_upper_left = lookfrom - focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    if aperture is not None:
        defocus_radius = aperture / 2.0
        defocus_angle_degrees = 2.0 * math.degrees(
            math.atan(defocus_radius / focus_dist)
        )
    else:
        defocus_radius = focus_dist * math.tan(
            math.radians(defocus_angle_degrees / 2.0)
        )

    return Camera(
        image_width=image_width,
        image_height=image_height,
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        center=lookfrom,
        pixel00_loc=pixel00_loc,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle=vec(defocus_angle_degrees),
    )


def camera_from_numpy(
    arrays: Mapping[str, np.ndarray],
    image_width: int,
    image_height: int,
    samples_per_pixel: int,
    max_depth: int,
    device="cuda",
) -> Camera:
    """Build a Camera from numpy arrays keyed by field name — e.g. the
    arrays of a JAX `Camera`, so both packages render one camera."""
    device = resolve_device(device)
    tensors = {
        f: torch.tensor(np.asarray(arrays[f]), dtype=torch.float32, device=device)
        for f in (*_VECTORS, "defocus_angle")
    }
    return Camera(
        image_width=image_width,
        image_height=image_height,
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        **tensors,
    )


def get_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor, keys):
    """Jittered camera rays for integer pixel coordinates (px = column, py =
    row) from per-ray threefry keys -> (origins [R, 3], directions [R, 3]).

    The JAX package's `get_rays` (models/camera.py:130-173), the array form
    of the reference's `get_ray` (reference: src/gpu/camera.h:140-167):
    four uniforms a ray from `fold_in(key, 1 << 20)`, a +-0.5-pixel jitter
    (u0, u1) around the pixel center, and the origin on the defocus disk at
    radius sqrt(u2), angle 2 pi u3 when `defocus_angle > 0`. Directions are
    NOT normalized (direction = sample - origin). The position sums are
    fused multiply-add chains, as XLA compiles them on the CPU."""
    u4 = sampling.uniforms_b(keys, 4, domain=CAMERA_DOMAIN)
    jitter = u4[..., 0:2] - 0.5
    fx = (px.to(torch.float32) + jitter[..., 0])[..., None]
    fy = (py.to(torch.float32) + jitter[..., 1])[..., None]
    pixel_sample = vm.fma(fy, cam.pixel_delta_v, vm.fma(fx, cam.pixel_delta_u, cam.pixel00_loc))
    if float(cam.defocus_angle) > 0.0:
        disk_r = vm.sqrt(u4[..., 2])
        disk_theta = sampling._TWO_PI * u4[..., 3]
        origin = vm.fma((disk_r * torch.sin(disk_theta))[..., None], cam.defocus_disk_v,
                        vm.fma((disk_r * torch.cos(disk_theta))[..., None], cam.defocus_disk_u,
                               cam.center))
    else:
        origin = cam.center.expand_as(pixel_sample)
    return origin, pixel_sample - origin
