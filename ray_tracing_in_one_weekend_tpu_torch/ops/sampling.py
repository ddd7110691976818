"""Stateless, counter-based random sampling on threefry keys.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/sampling.py,
on the port's copy of JAX's threefry (`ops/threefry.py`): the same keys
give the same uniforms, bit for bit. The reference's stateful RNG (a
shared mt19937 on the CPU, per-pixel curand streams on the GPU,
reference: src/gpu/camera.h:186-187) becomes
``key = fold_in(fold_in(base_key, global_pixel), global_sample)`` with
per-use subkeys from further `fold_in` calls, so every draw is a pure
function of global indices, independent of chunking and sharding.

A key is a pair of uint32 words (`threefry.key(seed)`), and a batch of
keys a pair of [R] int64 tensors: the `_b` functions are the JAX
package's vmapped per-lane draws, and every function here broadcasts the
same way (a draw of `shape` from [R] keys is [R, *shape]).

The rejection samplers of the reference become closed forms with the
same law (polar disk, normalized Gaussian direction, U^(1/3) radius).
`normal` is JAX's: a uniform on (nextafter(-1, 0), 1) mapped by
sqrt(2) erfinv. Its uniforms are JAX's bits; erfinv, log, sin and cos
are torch's, which agree with XLA's to a few float32 ulps, not bit for
bit (tests/test_torch_threefry.py states the bounds).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import threefry
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm

_TWO_PI = 2.0 * math.pi
# normal's uniform: the open interval (nextafter(-1, 0), 1).
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def pixel_sample_key(base_key, pixel_index, sample_index):
    """Per-(pixel, sample) key: the analogue of the reference's
    `curand_init(seed, pixel_index, 0)` stream (reference:
    src/gpu/camera.h:186-191)."""
    return threefry.fold_in(threefry.fold_in(base_key, pixel_index), sample_index)


def uniform(key, shape=()) -> torch.Tensor:
    """U[0,1) float32 (reference: src/gpu/rtweekend.h:20-29)."""
    return threefry.uniform(key, shape)


def normal(key, shape=()) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erfinv(u) for u
    uniform on (nextafter(-1, 0), 1)."""
    u = threefry.uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * torch.special.erfinv(u)


def random_unit_vector(key, shape=()) -> torch.Tensor:
    """Uniform direction on S^2 (reference: src/gpu/rtweekend.h:51-53): a
    normalized Gaussian, guarded against the all-zero draw."""
    g = normal(key, (*shape, 3))
    sq = vm.length_squared(g)[..., None]
    return g * torch.rsqrt(torch.clamp(sq, min=1e-12))


def random_in_unit_sphere(key, shape=()) -> torch.Tensor:
    """Uniform in the unit ball (reference: src/gpu/rtweekend.h:42-49)."""
    k_dir, k_r = _split2(key)
    direction = random_unit_vector(k_dir, shape)
    radius = threefry.uniform(k_r, (*shape, 1)) ** (1.0 / 3.0)
    return direction * radius


def random_on_hemisphere(key, normal_vec: torch.Tensor) -> torch.Tensor:
    """Uniform on the hemisphere around `normal_vec` (reference:
    src/gpu/rtweekend.h:55-59). One key draws a direction for every
    normal of the batch, as the JAX function does."""
    v = random_unit_vector(key, normal_vec.shape[:-1])
    same_side = vm.dot_fma(v, normal_vec)[..., None] > 0.0
    return torch.where(same_side, v, -v)


def random_in_unit_disk(key, shape=()) -> torch.Tensor:
    """Uniform in the unit disk, z = 0 (reference: src/gpu/rtweekend.h:61-69),
    by polar inversion: r = sqrt(U1), theta = 2 pi U2."""
    k_r, k_t = _split2(key)
    r = vm.sqrt(threefry.uniform(k_r, shape))
    theta = _TWO_PI * threefry.uniform(k_t, shape)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)


def random_vec3(key, lo: float = 0.0, hi: float = 1.0, shape=()) -> torch.Tensor:
    """Component-wise uniform vec3 in [lo, hi) (reference: src/gpu/main.cu:47-51)."""
    return threefry.uniform(key, (*shape, 3), lo, hi)


def _split2(key):
    w0, w1 = threefry.split(key, 2)
    return (w0[..., 0], w1[..., 0]), (w0[..., 1], w1[..., 1])


# ---------------------------------------------------------------------------
# Per-ray key-array draws: [R] keys -> one draw a lane.
# ---------------------------------------------------------------------------


def fold_b(keys, data):
    """fold_in over a key array; `data` is a scalar or per-lane tensor."""
    return threefry.fold_in(keys, data)


def uniform_b(keys) -> torch.Tensor:
    """One U[0,1) per key: [R] keys -> [R]."""
    return threefry.uniform(keys)


def uniform2_b(keys) -> torch.Tensor:
    """Two U[0,1) per key: [R] keys -> [R, 2]."""
    return threefry.uniform(keys, (2,))


def unit_vector_b(keys) -> torch.Tensor:
    """One uniform S^2 direction per key: [R] keys -> [R, 3]."""
    return random_unit_vector(keys)


def in_unit_disk_b(keys) -> torch.Tensor:
    """One uniform unit-disk point per key: [R] keys -> [R, 3] (z = 0)."""
    return random_in_unit_disk(keys)


def uniforms_b(keys, n: int, domain: int = 0) -> torch.Tensor:
    """n U[0,1) per key, `fold_in(k, domain)` then counters 0..n-1:
    [R] keys -> [R, n]. `domain` separates draw sites sharing a key
    (camera rays vs bounce draws)."""
    return threefry.uniform(threefry.fold_in(keys, domain), (n,))


def unit_vector_from_uniforms(u4: torch.Tensor) -> torch.Tensor:
    """[..., 4] uniforms -> [..., 3] uniform directions on S^2: Box-Muller
    Gaussians from (u0, u1) and (u2, u3), the radii floored at u = 1e-12,
    then normalized (squared length floored at 1e-12)."""
    u0 = torch.clamp(u4[..., 0], min=1e-12)
    u2 = torch.clamp(u4[..., 2], min=1e-12)
    r1 = vm.sqrt(-2.0 * torch.log(u0))
    r2 = vm.sqrt(-2.0 * torch.log(u2))
    t1 = _TWO_PI * u4[..., 1]
    t2 = _TWO_PI * u4[..., 3]
    g = torch.stack([r1 * torch.cos(t1), r1 * torch.sin(t1), r2 * torch.cos(t2)], dim=-1)
    sq = vm.length_squared(g)[..., None]
    return g * torch.rsqrt(torch.clamp(sq, min=1e-12))
