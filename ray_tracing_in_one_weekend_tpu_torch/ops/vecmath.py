"""Vector math on trailing-axis-3 tensors — the part the camera needs.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/vecmath.py
(reference: src/gpu/vec3.h:97-109). Each function spells out the JAX
version's operation order, so the camera derived from the same inputs
agrees to float32 rounding.
"""

from __future__ import annotations

import torch


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
    a zero vector normalizes to zero instead of NaN."""
    sq = dot(v, v)
    safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
    scale = torch.where(sq > 0.0, 1.0 / torch.sqrt(safe), torch.zeros_like(sq))
    return v * scale[..., None]
