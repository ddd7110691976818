"""Structure-of-arrays sphere scene + scene generators, on tensors.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/models/scene.py.
The reference builds its world as heap objects behind virtual
`hittable*` / `material*` pointers (reference: src/gpu/main.cu:18-75);
here, as in the JAX package, the scene is flat arrays (SoA) padded to a
static slot count, material polymorphism is an integer `mat_type`, and
rejected grid cells of the cover scene stay in the arrays with
`active=False`.

Scene builders build on the card (`device="cuda"`) unless the caller
passes another device, such as `device="cpu"`; without a GPU the default
raises rather than building on the CPU. Random layouts draw from a numpy
`Generator`; `scene_from_numpy` carries a JAX-built scene's arrays over
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

# Material type codes (replaces virtual dispatch on material*,
# reference: src/gpu/material.h:10-16).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

# Cover scene: 1 ground + 22*22 grid + 3 heroes = 488, padded to 512.
COVER_SCENE_SLOTS = 512

_FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")


@dataclasses.dataclass(frozen=True)
class Scene:
    """SoA sphere scene. All tensors share the leading slot axis [N]."""

    center: torch.Tensor  # [N, 3] float32
    radius: torch.Tensor  # [N] float32; negative = hollow (inward normal)
    albedo: torch.Tensor  # [N, 3] float32 (lambertian/metal)
    fuzz: torch.Tensor  # [N] float32 (metal only; clamped to <= 1)
    ior: torch.Tensor  # [N] float32 (dielectric only)
    mat_type: torch.Tensor  # [N] int32 in {0, 1, 2}
    active: torch.Tensor  # [N] bool; padding / rejected slots are False

    @property
    def num_slots(self) -> int:
        return self.center.shape[0]

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    @property
    def device(self) -> torch.device:
        return self.center.device

    def to(self, device) -> "Scene":
        return Scene(**{f: getattr(self, f).to(device) for f in _FIELDS})

    def replace(self, **updates) -> "Scene":
        return dataclasses.replace(self, **updates)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device without a GPU raises: the
    builders never fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA GPU, and torch sees none "
                           "(pass device='cpu' to build on the CPU)")
    return device


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Scene:
    """Build a Scene from numpy arrays keyed by field name — e.g. the
    arrays of a JAX `Scene`, so both packages render one layout."""
    device = resolve_device(device)
    dtypes = {"mat_type": torch.int32, "active": torch.bool}
    return Scene(
        **{
            f: torch.tensor(np.asarray(arrays[f]), dtype=dtypes.get(f, torch.float32), device=device)
            for f in _FIELDS
        }
    )


def from_spheres(
    centers: Sequence[Sequence[float]],
    radii: Sequence[float],
    mat_types: Sequence[int],
    albedos: Sequence[Sequence[float]] | None = None,
    fuzzes: Sequence[float] | None = None,
    iors: Sequence[float] | None = None,
    pad_to: int | None = None,
    device="cuda",
) -> Scene:
    """Build a Scene from per-sphere lists (test/bench convenience)."""
    n = len(radii)
    albedos = albedos if albedos is not None else [[1.0, 1.0, 1.0]] * n
    fuzzes = fuzzes if fuzzes is not None else [0.0] * n
    iors = iors if iors is not None else [1.5] * n

    pad = 0 if pad_to is None else max(0, pad_to - n)
    f32 = np.float32
    arrays = {
        "center": np.concatenate([np.asarray(centers, f32), np.zeros((pad, 3), f32)]),
        "radius": np.concatenate([np.asarray(radii, f32), np.ones(pad, f32)]),
        "albedo": np.concatenate([np.asarray(albedos, f32), np.zeros((pad, 3), f32)]),
        # Reference clamps metal fuzz to <= 1 at construction
        # (reference: src/gpu/material.h:44-45).
        "fuzz": np.minimum(
            np.concatenate([np.asarray(fuzzes, f32), np.zeros(pad, f32)]), 1.0
        ),
        "ior": np.concatenate([np.asarray(iors, f32), np.ones(pad, f32)]),
        "mat_type": np.concatenate(
            [np.asarray(mat_types, np.int32), np.zeros(pad, np.int32)]
        ),
        "active": np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    }
    return scene_from_numpy(arrays, device)


def single_sphere_scene(pad_to: int | None = None, device="cuda") -> Scene:
    """One lambertian sphere in front of the camera + gradient sky."""
    return from_spheres(
        centers=[[0.0, 0.0, -1.0], [0.0, -100.5, -1.0]],
        radii=[0.5, 100.0],
        mat_types=[LAMBERTIAN, LAMBERTIAN],
        albedos=[[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
        pad_to=pad_to,
        device=device,
    )


def three_sphere_scene(pad_to: int | None = None, device="cuda") -> Scene:
    """Ground + lambertian / dielectric / metal trio — the
    metal+dielectric milestone scene (reference: archive/listing50 era)."""
    return from_spheres(
        centers=[
            [0.0, -100.5, -1.0],
            [0.0, 0.0, -1.0],
            [-1.0, 0.0, -1.0],
            [1.0, 0.0, -1.0],
        ],
        radii=[100.0, 0.5, 0.5, 0.5],
        mat_types=[LAMBERTIAN, LAMBERTIAN, DIELECTRIC, METAL],
        albedos=[
            [0.8, 0.8, 0.0],
            [0.1, 0.2, 0.5],
            [1.0, 1.0, 1.0],
            [0.8, 0.6, 0.2],
        ],
        fuzzes=[0.0, 0.0, 0.0, 0.0],
        iors=[1.5, 1.5, 1.5, 1.5],
        pad_to=pad_to,
        device=device,
    )


def cover_scene_reference(pad_to: int = COVER_SCENE_SLOTS, device="cuda") -> Scene:
    """The EXACT cover scene the reference CPU build renders.

    Replays `random_scene()` (reference: src/cpu/main.cc:32-76) draw for
    draw against a bit-exact std::mt19937(5489) +
    uniform_real_distribution<double> replica (utils/reference_rng.py).
    Sphere order matches the reference's world list: ground, accepted
    grid spheres, three heroes.
    """
    from ray_tracing_in_one_weekend_tpu_torch.utils.reference_rng import (
        ReferenceRandom,
    )

    rng = ReferenceRandom()
    centers = [[0.0, -1000.0, 0.0]]
    radii = [1000.0]
    mats = [LAMBERTIAN]
    albedos = [[0.5, 0.5, 0.5]]
    fuzzes = [0.0]
    iors = [1.5]

    # NOTE on draw order: C++ argument evaluation order is unspecified,
    # and g++ (which built the golden) evaluates call arguments
    # RIGHT-TO-LEFT. So in `point3(a + 0.9*rd(), 0.2, b + 0.9*rd())` the
    # z-offset is drawn BEFORE the x-offset, and `vec3::random()` draws
    # its components z,y,x. A left-to-right replay places every grid
    # sphere wrong.
    def rand_vec3_rtl(lo=0.0, hi=1.0):
        z = rng.random_double(lo, hi)
        y = rng.random_double(lo, hi)
        x = rng.random_double(lo, hi)
        return (x, y, z)

    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random_double()
            cz = b + 0.9 * rng.random_double()  # drawn first (see NOTE)
            cx = a + 0.9 * rng.random_double()
            dx, dz = cx - 4.0, cz
            if (dx * dx + dz * dz) ** 0.5 > 0.9:
                if choose_mat < 0.8:
                    a1 = rand_vec3_rtl()
                    a2 = rand_vec3_rtl()
                    albedo = [a1[0] * a2[0], a1[1] * a2[1], a1[2] * a2[2]]
                    mats.append(LAMBERTIAN)
                    albedos.append(albedo)
                    fuzzes.append(0.0)
                elif choose_mat < 0.95:
                    albedo = list(rand_vec3_rtl(0.5, 1.0))
                    fuzz = rng.random_double(0.0, 0.5)
                    mats.append(METAL)
                    albedos.append(albedo)
                    fuzzes.append(fuzz)
                else:
                    mats.append(DIELECTRIC)
                    albedos.append([1.0, 1.0, 1.0])
                    fuzzes.append(0.0)
                centers.append([cx, 0.2, cz])
                radii.append(0.2)
                iors.append(1.5)

    for c, r, m, alb, fz in (
        ([0.0, 1.0, 0.0], 1.0, DIELECTRIC, [1.0, 1.0, 1.0], 0.0),
        ([-4.0, 1.0, 0.0], 1.0, LAMBERTIAN, [0.4, 0.2, 0.1], 0.0),
        ([4.0, 1.0, 0.0], 1.0, METAL, [0.7, 0.6, 0.5], 0.0),
    ):
        centers.append(c)
        radii.append(r)
        mats.append(m)
        albedos.append(alb)
        fuzzes.append(fz)
        iors.append(1.5)

    return from_spheres(
        centers=centers,
        radii=radii,
        mat_types=mats,
        albedos=albedos,
        fuzzes=fuzzes,
        iors=iors,
        pad_to=pad_to,
        device=device,
    )


def cover_scene(
    seed: int = 0, pad_to: int = COVER_SCENE_SLOTS, device="cuda"
) -> Scene:
    """The 488-sphere "cover scene" (reference: src/gpu/main.cu:18-75,
    src/cpu/main.cc:32-76), drawn from `np.random.default_rng(seed)`.

    Same semantics and slot layout as the JAX `cover_scene`; the JAX one
    draws with threefry, so the two layouts differ sphere by sphere and
    agree in law:

    * slots 0-3: ground lambertian(0.5) r=1000 at (0,-1000,0), then the
      heroes dielectric(1.5) at (0,1,0), lambertian(0.4,0.2,0.1) at
      (-4,1,0), metal((0.7,0.6,0.5), fuzz 0) at (4,1,0), all r=1;
    * slots 4-487: the 22x22 grid over a, b in [-11, 11), center
      (a + 0.9*U, 0.2, b + 0.9*U), r=0.2, INACTIVE within 0.9 of
      (4, 0.2, 0) (reference: src/gpu/main.cu:42);
    * material mix: U < 0.8 lambertian (albedo = U3*U3), U < 0.95 metal
      (albedo in [0.5, 1), fuzz in [0, 0.5)), else dielectric(1.5);
    * slots 488+: inactive padding.
    """
    rng = np.random.default_rng(seed)
    aa, bb = np.meshgrid(np.arange(-11, 11), np.arange(-11, 11), indexing="ij")
    a = aa.reshape(-1).astype(np.float32)
    b = bb.reshape(-1).astype(np.float32)
    n_grid = a.shape[0]

    f32 = np.float32
    choose_mat = rng.random(n_grid, f32)
    off_x = rng.random(n_grid, f32)
    off_z = rng.random(n_grid, f32)
    u1 = rng.random((n_grid, 3), f32)
    u2 = rng.random((n_grid, 3), f32)
    fuzz = f32(0.5) * rng.random(n_grid, f32)

    grid_center = np.stack(
        [a + f32(0.9) * off_x, np.full_like(a, 0.2), b + f32(0.9) * off_z], axis=-1
    )
    dist = np.linalg.norm(grid_center - np.asarray([4.0, 0.2, 0.0], f32), axis=-1)
    grid_active = dist > 0.9

    is_lam = choose_mat < 0.8
    is_metal = (choose_mat >= 0.8) & (choose_mat < 0.95)
    grid_mat = np.where(is_lam, LAMBERTIAN, np.where(is_metal, METAL, DIELECTRIC))
    grid_albedo = np.where(is_lam[:, None], u1 * u2, f32(0.5) + f32(0.5) * u1)
    grid_fuzz = np.where(is_metal, fuzz, f32(0.0))

    fixed_center = np.asarray(
        [[0.0, -1000.0, 0.0], [0.0, 1.0, 0.0], [-4.0, 1.0, 0.0], [4.0, 1.0, 0.0]], f32
    )
    fixed_albedo = np.asarray(
        [[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]], f32
    )
    pad = max(0, pad_to - 4 - n_grid)

    def cat(fixed, grid, pad_value, dtype):
        fixed = np.asarray(fixed, dtype)
        grid = np.asarray(grid, dtype)
        return np.concatenate(
            [fixed, grid, np.full((pad, *fixed.shape[1:]), pad_value, dtype)]
        )

    arrays = {
        "center": cat(fixed_center, grid_center, 0.0, f32),
        "radius": cat([1000.0, 1.0, 1.0, 1.0], np.full(n_grid, 0.2), 1.0, f32),
        "albedo": cat(fixed_albedo, grid_albedo, 0.0, f32),
        "fuzz": cat(np.zeros(4), grid_fuzz, 0.0, f32),
        "ior": cat(np.full(4, 1.5), np.full(n_grid, 1.5), 1.0, f32),
        "mat_type": cat(
            [LAMBERTIAN, DIELECTRIC, LAMBERTIAN, METAL], grid_mat, 0, np.int32
        ),
        "active": cat(np.ones(4, bool), grid_active, False, bool),
    }
    return scene_from_numpy(arrays, device)
