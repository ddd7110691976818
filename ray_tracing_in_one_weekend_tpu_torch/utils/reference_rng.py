"""Bit-exact replica of the reference CPU build's RNG stream.

The reference's scene generator draws from a default-constructed
`std::mt19937` (fixed seed 5489) through
`std::uniform_real_distribution<double>(0,1)`
(reference: src/cpu/rtweekend.h:27-36), so its cover scene is fully
deterministic. Replicating that stream lets `cover_scene_reference()`
(models/scene.py) build the EXACT sphere layout/materials the reference
renders — the prerequisite for golden-image parity against
tests/goldens/ref_cpu_cover_1200x800_500spp.png.

Implementation notes:
* MT19937: the textbook Matsumoto-Nishimura generator (public
  algorithm), 624-word state, standard seeding/twist/tempering.
* `uniform_real_distribution<double>` in libstdc++ draws
  ceil(53/32) = 2 engine words and combines them low-word-first:
  u = (x0 + x1 * 2^32) / 2^64 (std::generate_canonical). libstdc++
  accumulates in 80-bit long double before narrowing; Python's exact
  integer division below agrees except possibly the last ulp, far
  below float32 scene precision.

A copy of ray_tracing_in_one_weekend_tpu/utils/reference_rng.py: that
package's `__init__` imports jax and flax, which the port never does.
"""

from __future__ import annotations


class MT19937:
    """Mersenne Twister (the std::mt19937 engine), default seed 5489."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        mt = [0] * self.N
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.mt = mt
        self.index = self.N

    def _twist(self) -> None:
        mt, N, M = self.mt, self.N, self.M
        for i in range(N):
            y = (mt[i] & self.UPPER) | (mt[(i + 1) % N] & self.LOWER)
            mt[i] = mt[(i + M) % N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= self.MATRIX_A
        self.index = 0

    def genrand(self) -> int:
        """Next tempered 32-bit output."""
        if self.index >= self.N:
            self._twist()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


class ReferenceRandom:
    """The reference's `random_double()` stream
    (reference: src/cpu/rtweekend.h:27-36)."""

    def __init__(self, seed: int = 5489):
        self._eng = MT19937(seed)

    def random_double(self, lo: float = 0.0, hi: float = 1.0) -> float:
        x0 = self._eng.genrand()
        x1 = self._eng.genrand()
        u = (x0 + (x1 << 32)) / 18446744073709551616.0  # / 2^64
        return lo + (hi - lo) * u

    def random_vec3(self, lo: float = 0.0, hi: float = 1.0):
        """vec3::random(lo, hi) — three component draws in r,g,b order
        (reference: src/cpu/vec3.h:11-18)."""
        return (
            self.random_double(lo, hi),
            self.random_double(lo, hi),
            self.random_double(lo, hi),
        )
