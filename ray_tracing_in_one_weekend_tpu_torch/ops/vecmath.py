"""Vector math on trailing-axis-3 tensors.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/vecmath.py
(reference: src/gpu/vec3.h:56-121). `dot`, `cross` and `unit_vector`
spell out the JAX version's operation order with one rounding an
operation, as the camera derivation needs.

The keyed (threefry) path follows the JAX functions as XLA compiles them
on the CPU, which contracts a product that feeds an add into one fused
multiply-add: `fma` is that operation, rounded once, on any device, and
`dot_fma`, `length_squared`, `reflect` and `ray_at` use it where XLA does
(found by comparing bits; `ops/intersect.py` says where). Each stays
differentiable: the gradient of `fma(a, b, c)` is that of a * b + c.
"""

from __future__ import annotations

import torch

# Matches the reference's near-zero test threshold 1e-8
# (reference: src/gpu/vec3.h:56-60).
_NEAR_ZERO_EPS = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (reference: src/gpu/vec3.h:97-99)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D cross product (reference: src/gpu/vec3.h:101-105)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def unit_vector(v: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis (reference: src/gpu/vec3.h:107-109);
    a zero vector normalizes to zero instead of NaN, and its gradient is
    zero rather than NaN (the double-where of the JAX version)."""
    sq = dot(v, v)
    safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
    scale = torch.where(sq > 0.0, 1.0 / torch.sqrt(safe), torch.zeros_like(sq))
    return v * scale[..., None]


def _fma_value(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding. In float64 the product is exact
    (24 + 24 bits); the sum is rounded to odd (TwoSum gives its exact
    error, and an inexact even result steps one ulp towards it), and a
    round-to-odd result with 29 bits to spare rounds to the correctly
    rounded float32 (Boldo and Melquiond's rule)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    s = torch.where(step, torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)), s)
    return s.float()


def fma(a, b, c) -> torch.Tensor:
    """IEEE fused multiply-add on float32 tensors (broadcasting): a * b + c
    rounded once, the same bits on the CPU and the card (where the kernel
    calls __fmaf_rn). Under autograd the value stays the fused one and the
    gradient is that of a * b + c."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b, c))
    with torch.no_grad():
        value = _fma_value(a, b, c)
    if not (a.requires_grad or b.requires_grad or c.requires_grad):
        return value
    plain = a * b + c
    return value + (plain - plain.detach())


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis as XLA's CPU dot and reduce give
    it: fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot_fma(v, v)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE float32 sqrt, correctly rounded as sqrtf and XLA's are: torch's
    vectorized CPU sqrt is off by an ulp on some inputs."""
    return torch.sqrt(x.double()).float()


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt(length_squared(v))


def unit_vector_fma(v: torch.Tensor) -> torch.Tensor:
    """`unit_vector` with the squared length as `length_squared` gives it,
    for the keyed path: v * (1 / sqrt(|v|^2)), zero for a zero vector."""
    sq = length_squared(v)
    safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
    scale = torch.where(sq > 0.0, 1.0 / sqrt(safe), torch.zeros_like(sq))
    return v * scale[..., None]


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where all components are ~0 (reference: src/gpu/vec3.h:56-60)."""
    return torch.all(torch.abs(v) < _NEAR_ZERO_EPS, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about unit normal n (reference: src/gpu/vec3.h:111-113):
    v - 2 (v . n) n, the product and the subtraction fused."""
    return fma(-2.0 * dot_fma(v, n)[..., None], n, v)


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat: torch.Tensor) -> torch.Tensor:
    """Snell refraction via perpendicular/parallel decomposition
    (reference: src/gpu/vec3.h:115-121). `uv` unit, `n` the unit normal
    facing against the ray; lanes of total internal reflection (k <= 0)
    get a zero parallel part, and a zero gradient through it."""
    cos_theta = torch.clamp(dot_fma(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * fma(cos_theta[..., None], n, uv)
    k = 1.0 - length_squared(r_out_perp)
    refractable = k > 0.0
    sqrt_k = torch.where(refractable, sqrt(torch.where(refractable, k, 1.0)), 0.0)
    return fma(-sqrt_k[..., None], n, r_out_perp)


def ray_at(origin: torch.Tensor, direction: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Point along a ray: origin + t * direction (reference: src/gpu/ray.h:16-18)."""
    return fma(t[..., None], direction, origin)
