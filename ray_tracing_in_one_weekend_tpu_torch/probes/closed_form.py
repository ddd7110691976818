"""Render probes whose radiance has a closed form, for any renderer.

The scenes and cameras of the JAX package's render-level probes
(tests/test_pallas.py: hollow glass, defocus blur, the fuzz-0 mirror, the
ior-1 pass-through and the black lambertian), each with the closed form
it is held to. Paths are built so that the random draws cancel or average
out, so a renderer that is right meets the closed form to the stated
limit, whatever its streams; a few-percent radiance fault of one material
cannot hide in Monte-Carlo noise. `evaluate` renders a probe with any
`render(scene, cam) -> [H, W, 3]` (the kernel, the plain version) and
reads it against its limit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera, make_camera

PROBES = ("hollow_glass", "defocus", "mirror", "ior1", "black")
MIRROR_ALBEDO = (0.8, 0.6, 0.2)
# Per-pixel limit of the mirror and ior-1 closed forms: the +-0.5 pixel
# jitter, averaged over the samples on the smooth sky (tests/test_pallas.py).
PIXEL_ATOL = 3e-3
# The hollow shell transmits: its center pixel's mean radiance exceeds this
# (a broken inward normal absorbs or darkens it).
HOLLOW_MIN = 0.1


def probe_camera(device, width=32, spp=8, **kw) -> Camera:
    """tests/test_pallas.py's `_cam`: 2:1, looking down -z from the origin,
    vfov 90, no lens, depth 6, unless overridden."""
    kw = {"aspect_ratio": 2.0, "lookfrom": (0.0, 0.0, 0.0), "lookat": (0.0, 0.0, -1.0),
          "vfov_degrees": 90.0, "defocus_angle_degrees": 0.0, "focus_dist": 1.0, "max_depth": 6,
          **kw}
    return make_camera(image_width=width, samples_per_pixel=spp, device=device, **kw)


def probe_setup(name: str, device) -> tuple[scene_lib.Scene, dict[str, Camera]]:
    """The probe's scene and its cameras by role."""
    if name == "hollow_glass":
        scene = scene_lib.from_spheres(
            centers=[[0, -100.5, -1], [0, 0, -1], [0, 0, -1], [-1, 0, -1], [1, 0, -1]],
            radii=[100.0, 0.5, -0.45, 0.5, 0.5],
            mat_types=[0, 2, 2, 0, 1],
            albedos=[[0.8, 0.8, 0.0], [1, 1, 1], [1, 1, 1], [0.1, 0.2, 0.5], [0.8, 0.6, 0.2]],
            pad_to=128, device=device)
        return scene, {"image": probe_camera(device, spp=24, max_depth=16)}
    if name == "defocus":
        return scene_lib.single_sphere_scene(pad_to=128, device=device), {
            "sharp": probe_camera(device, spp=64, defocus_angle_degrees=0.0, focus_dist=1.0),
            "blur": probe_camera(device, spp=64, defocus_angle_degrees=20.0, focus_dist=3.0)}
    if name == "mirror":
        scene = scene_lib.from_spheres(
            centers=[[0.0, 0.0, -3.0]], radii=[1.0], mat_types=[scene_lib.METAL],
            albedos=[list(MIRROR_ALBEDO)], fuzzes=[0.0], pad_to=128, device=device)
        return scene, {"image": probe_camera(device, spp=64, vfov_degrees=20.0, lookat=(0, 0, -3.0))}
    if name == "ior1":
        scene = scene_lib.from_spheres(
            centers=[[0.0, 0.0, -10.0]], radii=[1.0], mat_types=[scene_lib.DIELECTRIC],
            albedos=[[1.0, 1.0, 1.0]], iors=[1.0], pad_to=128, device=device)
        # The sphere subtends ~11 degrees: central rays hit with cos > 0.97.
        return scene, {"image": probe_camera(device, spp=32, vfov_degrees=8.0, lookat=(0, 0, -10.0),
                                             max_depth=8)}
    if name == "black":
        scene = scene_lib.from_spheres(
            centers=[[0.0, 0.0, -3.0]], radii=[1.0], mat_types=[scene_lib.LAMBERTIAN],
            albedos=[[0.0, 0.0, 0.0]], pad_to=128, device=device)
        return scene, {"image": probe_camera(device, spp=8, vfov_degrees=20.0, lookat=(0, 0, -3.0))}
    raise ValueError(f"unknown probe {name!r}; one of {PROBES}")


def sky(d) -> np.ndarray:
    """The closed-form sky gradient along `d` (reference: src/gpu/camera.h:118-124)."""
    d = np.asarray(d, np.float64)
    a = 0.5 * (d[1] / np.linalg.norm(d) + 1.0)
    return (1.0 - a) * np.ones(3) + a * np.array([0.5, 0.7, 1.0])


def pixel_dir(cam: Camera, px: float, py: float) -> np.ndarray:
    """The unit direction through the center of pixel (px, py), jitter-free."""
    f64 = {f: getattr(cam, f).detach().cpu().double().numpy()
           for f in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v")}
    d = f64["pixel00_loc"] + px * f64["pixel_delta_u"] + py * f64["pixel_delta_v"] - f64["center"]
    return d / np.linalg.norm(d)


def mirror_expected(cam: Camera) -> np.ndarray:
    """albedo * sky(reflect(d)) at the center pixel: fuzz-0 metal only
    reflects, so the draw cancels (the unit sphere at (0,0,-3), camera at
    the origin)."""
    h, w = cam.image_height, cam.image_width
    d = pixel_dir(cam, w // 2, h // 2)
    b = 3.0 * d[2]  # o - c = (0, 0, 3)
    t = -b - math.sqrt(b * b - 9.0 + 1.0)
    n = t * d - np.array([0.0, 0.0, -3.0])
    n /= np.linalg.norm(n)
    return np.asarray(MIRROR_ALBEDO) * sky(d - 2.0 * np.dot(d, n) * n)


def hgrad(img: np.ndarray) -> np.ndarray:
    return np.abs(np.diff(img, axis=1))


@dataclasses.dataclass(frozen=True)
class Reading:
    """One probe's closed-form reading: `value` against `limit`."""

    name: str
    value: float
    limit: float
    holds: bool
    what: str

    def line(self) -> str:
        return f"{self.name} {self.what} {self.value:.3e} (limit {self.limit:.3e}): {'holds' if self.holds else 'FAILS'}"


def evaluate(name: str, render, device) -> tuple[Reading, dict[str, torch.Tensor]]:
    """Render probe `name` with `render(scene, cam)` on `device` -> (its
    reading, the images by camera role)."""
    scene, cams = probe_setup(name, device)
    images = {role: render(scene, cam) for role, cam in cams.items()}
    img = {role: im.detach().cpu().double().numpy() for role, im in images.items()}
    cam = next(iter(cams.values()))
    h, w = cam.image_height, cam.image_width
    cy, cx = h // 2, w // 2
    finite = all(np.isfinite(im).all() for im in img.values())
    if name == "hollow_glass":
        value = float(img["image"][cy, cx].mean())
        reading = Reading(name, value, HOLLOW_MIN, finite and value > HOLLOW_MIN,
                          "center pixel mean radiance, above")
    elif name == "defocus":
        value, limit = float(hgrad(img["blur"]).max()), float(hgrad(img["sharp"]).max())
        reading = Reading(name, value, limit, finite and value < limit,
                          "largest horizontal gradient blurred, below the sharp one")
    elif name == "mirror":
        value = float(np.abs(img["image"][cy, cx] - mirror_expected(cam)).max())
        reading = Reading(name, value, PIXEL_ATOL, finite and value <= PIXEL_ATOL,
                          "center pixel off albedo * sky(reflect(d)), at most")
    elif name == "ior1":
        value = max(float(np.abs(img["image"][cy + dy, cx + dx] - sky(pixel_dir(cam, cx + dx, cy + dy))).max())
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        reading = Reading(name, value, PIXEL_ATOL, finite and value <= PIXEL_ATOL,
                          "central 3x3 pixels off sky(d), at most")
    else:
        value = float(np.abs(img["image"][cy - 3 : cy + 4, cx - 3 : cx + 4]).max())
        reading = Reading(name, value, 0.0, finite and value == 0.0, "central 7x7 pixels' largest radiance, exactly")
    return reading, images
