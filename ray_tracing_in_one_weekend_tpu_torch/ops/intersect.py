"""Batched closest-hit ray-sphere intersection, the JAX formula.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/intersect.py
(:71-123): every ray against every sphere as one [R, N] computation and
the nearest hit over the sphere axis, for rays whose direction is NOT
unit length (the keyed path's camera and scatter directions):

    a      = |d|^2
    half_b = o.d - d.C
    c      = |o|^2 - 2 o.C + (|C|^2 - r^2)
    disc   = half_b^2 - a c
    roots  = (-half_b -+ sqrt(disc)) * (1 / a)

with the nearest root in the open interval (t_min, t_max) (strict, as
the reference's `interval.surrounds`, reference: src/gpu/interval.h:6-28),
t_min = T_MIN_EPS = 1e-3, t_max = T_MISS = 1e30, and inactive slots
masked to T_MISS. (The PCG render kernel's sweep, `closest_hit`, assumes
a unit d and marks padding by r^2 = -1; neither holds here.)

The operations are XLA's on the CPU, where it contracts products into
fused multiply-adds: each dot product (the K = 3 HIGHEST matmuls
included) is fma(x2, y2, fma(x1, y1, x0 * y0)), |C|^2 - r^2 is
fma(-r, r, |C|^2) and disc is fma(half_b, half_b, -(a c)). Found by
comparing bits, they make `sphere_hit_ts` bit-equal to the JAX function
on the CPU; `csrc/threefry_render_kernel.cu` spells out the same
operations with __fmaf_rn.

Ties: the JAX function averages the parameters of tied winners (its
one-hot matmul, intersect.py:146-152); here, in the plain version and in
the kernel alike, the lowest sphere index wins, the convention of the
port's PCG render. An exact tie of two real spheres has measure zero.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm

# Sentinel "no hit" distance: large but finite, so min and the arithmetic
# after it never make inf - inf.
T_MISS = 1e30

# Shadow-acne epsilon (reference: src/gpu/camera.h:118).
T_MIN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Array-of-rays hit record (reference: src/gpu/hittable.h:10-27), with
    the hit sphere's material parameters gathered."""

    hit: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R]; 1 on a miss
    point: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3], facing against the incident ray
    front_face: torch.Tensor  # [R] bool
    sphere_index: torch.Tensor  # [R] int64
    albedo: torch.Tensor  # [R, 3]
    fuzz: torch.Tensor  # [R]
    ior: torch.Tensor  # [R]
    mat_type: torch.Tensor  # [R] int32


def _roots(a, half_b, c, t_min, t_max):
    """The nearest in-range root -> (t, valid): the double-where keeps sqrt
    off negative discriminants, so their gradient is zero, not NaN."""
    disc = vm.fma(half_b, half_b, -(a * c))
    has_root = disc > 0.0
    sqrt_d = vm.sqrt(torch.where(has_root, disc, 1.0))
    inv_a = 1.0 / a
    root_near = (-half_b - sqrt_d) * inv_a
    root_far = (-half_b + sqrt_d) * inv_a

    def in_range(t):
        return (t > t_min) & (t < t_max)

    t = torch.where(in_range(root_near), root_near, root_far)
    return t, has_root & in_range(t)


def _dot_cols(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[R, 3] x [N, 3] -> [R, N] dot products, XLA's fused order."""
    return vm.fma(x[:, 2:3], centers[:, 2], vm.fma(x[:, 1:2], centers[:, 1], x[:, 0:1] * centers[:, 0]))


def sphere_hit_ts(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_min: float = T_MIN_EPS,
    t_max: float = T_MISS,
) -> torch.Tensor:
    """Nearest in-range root for every (ray, sphere) pair -> [R, N]; misses
    (no real root in range, or an inactive slot) are T_MISS."""
    centers, radius = scene.center, scene.radius
    a = vm.length_squared(direction)[:, None]
    o_dot_d = vm.dot_fma(origin, direction)[:, None]
    o_sq = vm.length_squared(origin)[:, None]
    c_sq_minus_r_sq = vm.fma(-radius, radius, vm.length_squared(centers))[None, :]
    half_b = o_dot_d - _dot_cols(direction, centers)
    c = (o_sq - 2.0 * _dot_cols(origin, centers)) + c_sq_minus_r_sq
    t, valid = _roots(a, half_b, c, t_min, t_max)
    return torch.where(valid & scene.active[None, :], t, T_MISS)


def _winner_t(center, radius, origin, direction, t_min, t_max):
    """`sphere_hit_ts` of one sphere a ray ([R, 3] centers, [R] radii):
    the same operations on the same values, so the same bits, and a
    gradient to the sphere's center and radius."""
    a = vm.length_squared(direction)
    half_b = vm.dot_fma(origin, direction) - vm.dot_fma(direction, center)
    c = (vm.length_squared(origin) - 2.0 * vm.dot_fma(origin, center)) + vm.fma(
        -radius, radius, vm.length_squared(center))
    return _roots(a, half_b, c, t_min, t_max)[0]


def hit_scene(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_min: float = T_MIN_EPS,
    t_max: float = T_MISS,
) -> HitRecord:
    """Closest hit over all spheres (reference: src/gpu/hittable_list.h:49-65).

    The sweep and its minimum run without the tape, on detached inputs, so
    autograd records no [R, N] tensor; the winner's t is recomputed from its
    parameters with gradient (same bits: t_best + (t_rec - t_rec.detach())),
    and the winner's parameters are gathered by index, so gradients reach
    the winning sphere's center, radius, albedo, fuzz and ior as through the
    JAX function's one-hot matmul."""
    with torch.no_grad():
        ts = sphere_hit_ts(_detached(scene), origin.detach(), direction.detach(), t_min, t_max)
        t_best, index = torch.min(ts, dim=1)
    hit = t_best < T_MISS * 0.5
    center_h = scene.center[index]
    radius_h = scene.radius[index]
    t = t_best
    if torch.is_grad_enabled() and any(x.requires_grad for x in (center_h, radius_h, origin, direction)):
        t_rec = _winner_t(center_h, radius_h, origin, direction, t_min, t_max)
        t = t_best + torch.where(hit, t_rec - t_rec.detach(), 0.0)
    # Miss lanes get t = 1, so the geometry after stays finite.
    t_safe = torch.where(hit, t, 1.0)
    point = vm.ray_at(origin, direction, t_safe)
    outward = (point - center_h) / radius_h[:, None]
    front_face = vm.dot_fma(direction, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitRecord(
        hit=hit, t=t_safe, point=point, normal=normal, front_face=front_face,
        sphere_index=index, albedo=scene.albedo[index], fuzz=scene.fuzz[index],
        ior=scene.ior[index], mat_type=scene.mat_type[index],
    )


def _detached(scene: Scene) -> Scene:
    return Scene(**{f.name: getattr(scene, f.name).detach() for f in dataclasses.fields(scene)})
