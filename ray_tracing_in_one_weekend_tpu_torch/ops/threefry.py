"""Counter-based threefry2x32 keys, bit for bit as `jax.random` draws them.

The port's own copy of the threefry2x32 implementation of `jax.random`
as JAX 0.9 runs it with `jax_threefry_partitionable=True` (the default):
`jax/_src/prng.py` (`threefry_seed`, the 20 rounds, `split` in its
foldlike form, `fold_in`, partitionable `random_bits`) and
`jax/_src/random.py` (`_uniform`). It is a pure function of 32-bit words,
so the port draws the JAX package's numbers without JAX.

A key is a pair (k0, k1) of uint32 words in JAX's order: `key(seed)` is
(seed >> 32, seed & 0xFFFFFFFF). Each word is a Python int or an int64
tensor holding uint32 values (torch has no full uint32 arithmetic, so
every add and shift is masked to 32 bits, as the PCG streams of
`ops/cuda_render.py` are). Every function broadcasts over the words'
shape: a pair of [R] tensors is R keys, one a lane (the per-lane form of
the JAX package's vmapped `fold_b`, `uniforms_b`, ...), and a draw of
`shape` from them has shape [R, *shape].

`csrc/threefry.cuh` is the CUDA counterpart, in native uint32.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# uniform: the 23 mantissa bits under the exponent of 1.0.
_ONE_BITS = 0x3F800000


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _U32


def threefry_2x32(k, x0, x1):
    """The threefry2x32 block of key `k` = (k0, k1) on the counter words
    (x0, x1) -> (y0, y1), broadcasting over every operand: five groups of
    four rounds, each group followed by a key injection."""
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def key(seed: int):
    """`jax.random.key(seed)`'s words: (seed >> 32, seed & 0xFFFFFFFF) of
    the seed as a 64-bit integer."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & _U32


def as_key(base_key):
    """An int seed -> `key(seed)`; a key (a pair of words) as is."""
    if isinstance(base_key, (tuple, list)):
        return tuple(base_key)
    return key(int(base_key))


def fold_in(k, data):
    """`jax.random.fold_in(k, data)`: threefry_2x32(k, (0, data)). `data`
    (an int or an int64 tensor) is taken mod 2^32, as JAX casts it to
    uint32."""
    if isinstance(data, torch.Tensor):
        return threefry_2x32(k, 0, data.to(torch.int64) & _U32)
    return threefry_2x32(k, 0, int(data) & _U32)


def _device(k):
    for w in k:
        if isinstance(w, torch.Tensor):
            return w.device
    return None


def _counters(k, shape):
    """The counters 0 .. prod(shape)-1 in row-major order, shaped to
    broadcast against the key's words: [*key_shape, *shape]."""
    shape = tuple(shape)
    count = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                         device=_device(k)).reshape(shape)
    k = tuple(w.reshape(*w.shape, *([1] * len(shape))) if isinstance(w, torch.Tensor) else w
              for w in k)
    return k, count


def split(k, n: int = 2):
    """`jax.random.split(k, n)` in its foldlike form: key i is
    threefry_2x32(k, (0, i)) -> a pair of [*key_shape, n] tensors."""
    k, count = _counters(k, (n,))
    return threefry_2x32(k, 0, count)


def random_bits(k, shape=()):
    """32-bit `random_bits` of `shape`: bits1 ^ bits2 of
    threefry_2x32(k, (0, i)) on the row-major counters i ->
    [*key_shape, *shape] int64 holding uint32."""
    k, count = _counters(k, shape)
    b0, b1 = threefry_2x32(k, 0, count)
    return b0 ^ b1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1."""
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0


def uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)` ->
    [*key_shape, *shape] float32: max(minval, u * (maxval - minval) +
    minval), each step rounded to float32."""
    floats = bits_to_unit(random_bits(k, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)
