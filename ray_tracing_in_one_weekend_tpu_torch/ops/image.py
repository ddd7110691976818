"""Color pipeline: sample mean -> gamma 2 -> clamp -> 8-bit quantization.

Reproduces the reference's `write_color` exactly
(reference: src/gpu/color.h:12-38, src/cpu/color.h:8-23):

    gamma = sqrt(mean)                            ("gamma 2", linear_to_gamma)
    byte  = int(256 * clamp(gamma, 0, 0.999))

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/image.py.
"""

from __future__ import annotations

import torch

from ray_tracing_in_one_weekend_tpu_torch.utils.spans import spanned

# Clamp ceiling before the 256 scale (reference: src/gpu/color.h:30-33).
_CLAMP_MAX = 0.999


def linear_to_gamma(linear: torch.Tensor) -> torch.Tensor:
    """Gamma-2 transform: sqrt of the non-negative part
    (reference: src/gpu/color.h:12-14). The sqrt is taken in float64 and
    rounded, so it is the IEEE float32 sqrt on every device."""
    x = torch.clamp(linear, min=0.0)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


@spanned("rt.to_uint8")
def to_uint8(linear_image: torch.Tensor) -> torch.Tensor:
    """Linear [H, W, 3] float -> gamma-corrected uint8 [H, W, 3]
    (reference: src/gpu/color.h:16-38)."""
    clamped = torch.clamp(linear_to_gamma(linear_image), 0.0, _CLAMP_MAX)
    return (256.0 * clamped).to(torch.uint8)
