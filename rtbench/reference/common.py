"""The reference's inputs and output stage: the frozen cover scene, the
camera's derived constants and the 8-bit gamma output.

Frozen copies of the reference renderer's derivations (src/gpu/camera.h
:53-110, src/gpu/color.h:12-38) in the operation order the port uses, so
the reference derives from the same settings the same float32 values the
program does. Nothing here imports the port.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

SCENE_FILE = Path(__file__).with_name("cover_scene_0.npz")
FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")


def scene_arrays(path=SCENE_FILE) -> dict:
    """The scene's arrays as numpy, by field: what both sides are given."""
    with np.load(path) as z:
        return {f: np.array(z[f]) for f in FIELDS}


def scene_tensors(arrays: dict, device) -> dict:
    dtypes = {"mat_type": torch.int32, "active": torch.bool}
    return {f: torch.tensor(arrays[f], dtype=dtypes.get(f, torch.float32), device=device) for f in FIELDS}


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _unit(v):
    sq = _dot(v, v)
    safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
    return v * torch.where(sq > 0.0, 1.0 / torch.sqrt(safe), torch.zeros_like(sq))[..., None]


def make_camera(width: int, height: int, lookfrom, lookat, vup, vfov_degrees: float,
                defocus_angle_degrees: float, focus_dist: float, device) -> dict:
    """The camera's derived constants as float32 tensors on `device`, and
    its width."""
    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    lookfrom, lookat, vup = vec(lookfrom), vec(lookat), vec(vup)
    h = math.tan(math.radians(vfov_degrees) / 2.0)
    viewport_height = 2.0 * h * focus_dist
    viewport_width = viewport_height * (width / height)
    w = _unit(lookfrom - lookat)
    u = _unit(_cross(vup, w))
    v = _cross(w, u)
    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    delta_u = viewport_u / width
    delta_v = viewport_v / height
    upper_left = lookfrom - focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    radius = focus_dist * math.tan(math.radians(defocus_angle_degrees / 2.0))
    return {"width": width, "height": height, "center": lookfrom,
            "pixel00_loc": upper_left + 0.5 * (delta_u + delta_v), "pixel_delta_u": delta_u,
            "pixel_delta_v": delta_v, "defocus_disk_u": u * radius, "defocus_disk_v": v * radius,
            "defocus_angle": vec(defocus_angle_degrees)}


def to_uint8(linear: torch.Tensor) -> torch.Tensor:
    """Linear color -> gamma 2, clamped to [0, 0.999], times 256, truncated."""
    x = torch.clamp(linear.float(), min=0.0)
    gamma = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return (256.0 * torch.clamp(gamma, 0.0, 0.999)).to(torch.uint8)
