"""Numbers drawn from a run's --seed: splitmix64 over the seed and a few
tags, so that every use (render seeds, keys, the check's sample) has a
stream of its own and any whole seed, however large, works."""

from __future__ import annotations

import hashlib

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def derive(seed: int, *tags) -> int:
    """A 64-bit number from `seed` and `tags` (strings or ints)."""
    z = _mix(int(seed) & _MASK)
    for tag in tags:
        t = int.from_bytes(hashlib.sha256(str(tag).encode()).digest()[:8], "little")
        z = _mix(z ^ t)
    return z


def key(seed: int, *tags) -> tuple:
    """A threefry key (two uint32 words) from `seed` and `tags`."""
    z = derive(seed, *tags)
    return z >> 32, z & 0xFFFFFFFF
