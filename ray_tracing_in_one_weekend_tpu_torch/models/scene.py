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
raises rather than building on the CPU. The cover scene draws from the
JAX package's threefry keys (`ops/threefry.py`), so one seed builds one
world in both packages; `scene_from_numpy` carries a JAX-built scene's
arrays over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import threefry
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm

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
    src/cpu/main.cc:32-76), drawn with threefry keys exactly as the JAX
    package's `cover_scene(seed)` draws it
    (ray_tracing_in_one_weekend_tpu/models/scene.py:225-322), so the two
    packages build the same world from one seed, bit for bit:

    * slots 0-3: ground lambertian(0.5) r=1000 at (0,-1000,0), then the
      heroes dielectric(1.5) at (0,1,0), lambertian(0.4,0.2,0.1) at
      (-4,1,0), metal((0.7,0.6,0.5), fuzz 0) at (4,1,0), all r=1;
    * slots 4-487: the 22x22 grid over a, b in [-11, 11). Cell i draws
      from `fold_in(key(seed), i)`, split into six keys k_mat, k_ox, k_oz,
      k_a1, k_a2, k_fz: center (a + 0.9 U(k_ox), 0.2, b + 0.9 U(k_oz)),
      r=0.2, INACTIVE within 0.9 of (4, 0.2, 0) (reference:
      src/gpu/main.cu:42);
    * material by U(k_mat): < 0.8 lambertian with albedo U3(k_a1) *
      U3(k_a2), < 0.95 metal with albedo U3(k_a1) in [0.5, 1) (the same
      k_a1) and fuzz U(k_fz) in [0, 0.5), else dielectric(1.5);
    * slots 488+: inactive padding (center 0, radius 1, ior 1).

    The distance's squares are a fused multiply-add chain, as XLA compiles
    the JAX function on the CPU. The draw runs on the CPU; the scene is
    built on `device`."""
    device = resolve_device(device)
    f32 = torch.float32
    aa, bb = np.meshgrid(np.arange(-11, 11), np.arange(-11, 11), indexing="ij")
    a = torch.tensor(aa.reshape(-1), dtype=f32)
    b = torch.tensor(bb.reshape(-1), dtype=f32)
    n_grid = a.shape[0]

    cells = threefry.fold_in(threefry.key(seed), torch.arange(n_grid))
    words = threefry.split(cells, 6)  # ([484, 6], [484, 6])
    k_mat, k_ox, k_oz, k_a1, k_a2, k_fz = ((words[0][:, i], words[1][:, i]) for i in range(6))
    choose_mat = threefry.uniform(k_mat)
    off_x = threefry.uniform(k_ox)
    off_z = threefry.uniform(k_oz)
    lam_albedo = threefry.uniform(k_a1, (3,)) * threefry.uniform(k_a2, (3,))
    metal_albedo = threefry.uniform(k_a1, (3,), 0.5, 1.0)
    fuzz = threefry.uniform(k_fz, (), 0.0, 0.5)

    grid_center = torch.stack(
        [a + 0.9 * off_x, torch.full_like(a, 0.2), b + 0.9 * off_z], dim=-1
    )
    dist = vm.length(grid_center - torch.tensor([4.0, 0.2, 0.0], dtype=f32))
    grid_active = dist > 0.9

    is_lam = choose_mat < 0.8
    is_metal = (choose_mat >= 0.8) & (choose_mat < 0.95)
    grid_mat = torch.where(is_lam, LAMBERTIAN, torch.where(is_metal, METAL, DIELECTRIC))
    grid_albedo = torch.where(is_lam[:, None], lam_albedo, metal_albedo)
    grid_fuzz = torch.where(is_metal, fuzz, 0.0)

    fixed_center = [[0.0, -1000.0, 0.0], [0.0, 1.0, 0.0], [-4.0, 1.0, 0.0], [4.0, 1.0, 0.0]]
    fixed_albedo = [[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]]
    pad = max(0, pad_to - 4 - n_grid)

    def cat(fixed, grid, pad_value, dtype):
        fixed = torch.tensor(fixed, dtype=dtype)
        grid = torch.as_tensor(grid).to(dtype)
        return torch.cat([fixed, grid, torch.full((pad, *fixed.shape[1:]), pad_value, dtype=dtype)])

    return Scene(
        center=cat(fixed_center, grid_center, 0.0, f32).to(device),
        radius=cat([1000.0, 1.0, 1.0, 1.0], torch.full((n_grid,), 0.2), 1.0, f32).to(device),
        albedo=cat(fixed_albedo, grid_albedo, 0.0, f32).to(device),
        fuzz=cat([0.0] * 4, grid_fuzz, 0.0, f32).to(device),
        ior=cat([1.5] * 4, torch.full((n_grid,), 1.5), 1.0, f32).to(device),
        mat_type=cat([LAMBERTIAN, DIELECTRIC, LAMBERTIAN, METAL], grid_mat, 0, torch.int32).to(device),
        active=cat([True] * 4, grid_active, False, torch.bool).to(device),
    )
