"""Branchless material scattering on the keyed path.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/ops/materials.py
(:45-122): all three material responses are computed for every lane and
the winner selected by `mat_type` (the reference's virtual
`material::scatter`, reference: src/gpu/material.h:10-104):

* lambertian: normal + unit sample, the normal itself when that is near
  zero; attenuation = albedo; always scatters;
* metal: reflect(unit(in), normal) + fuzz * unit sample (the GPU tree's
  v4 form); absorbed when that points into the surface;
* dielectric: attenuation 1, ratio 1/ior entering and ior leaving, total
  internal reflection when ratio sin(theta) > 1 (sin_theta floored at
  1e-12 under the square root), else Schlick's reflectance against a
  uniform picks reflect or refract.

Lambertian and metal share the one unit sample, as in the JAX function.
Products that feed an add are fused multiply-adds where XLA fuses them on
the CPU (`ops/vecmath.py`). Gradients flow through the continuous
quantities; the branch decisions are constants, the Monte-Carlo-discrete
gradient of tests/test_grad.py.
"""

from __future__ import annotations

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.scene import DIELECTRIC, LAMBERTIAN, METAL
from ray_tracing_in_one_weekend_tpu_torch.ops import sampling
from ray_tracing_in_one_weekend_tpu_torch.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu_torch.ops.intersect import HitRecord


def schlick_reflectance(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation r0 + (1 - r0)(1 - cos)^5 (reference:
    src/gpu/material.h:98-103); x^5 as x * (x^2)^2, the multiplication
    order of JAX's integer_pow."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return vm.fma(1.0 - r0, x * (x2 * x2), r0)


def scatter(rec: HitRecord, in_direction: torch.Tensor, keys):
    """Scatter with randomness drawn from per-ray keys: the unit sample from
    `fold_in(key, 0)`, the reflect uniform from `fold_in(key, 1)`."""
    unit_sample = sampling.unit_vector_b(sampling.fold_b(keys, 0))
    reflect_u = sampling.uniform_b(sampling.fold_b(keys, 1))
    return scatter_sampled(rec, in_direction, unit_sample, reflect_u)


def scatter_sampled(rec: HitRecord, in_direction: torch.Tensor, unit_sample: torch.Tensor,
                    reflect_u: torch.Tensor):
    """Scatter every ray against its hit material -> (direction [R, 3] (not
    unit), attenuation [R, 3], scattered_ok [R]); `scattered_ok` is False
    only for an absorbed metal ray (reference: src/gpu/material.h:58)."""
    unit_in = vm.unit_vector_fma(in_direction)
    normal = rec.normal

    # lambertian (reference: src/gpu/material.h:24-36)
    lam_dir = normal + unit_sample
    lam_dir = torch.where(vm.near_zero(lam_dir)[:, None], normal, lam_dir)

    # metal (reference: src/gpu/material.h:47-59)
    reflected = vm.reflect(unit_in, normal)
    metal_dir = vm.fma(rec.fuzz[:, None], unit_sample, reflected)
    metal_ok = vm.dot_fma(metal_dir, normal) > 0.0

    # dielectric (reference: src/gpu/material.h:70-93)
    ratio = torch.where(rec.front_face, 1.0 / rec.ior, rec.ior)
    cos_theta = torch.clamp(vm.dot_fma(-unit_in, normal), max=1.0)
    sin_theta = vm.sqrt(torch.clamp(vm.fma(-cos_theta, cos_theta, 1.0), min=1e-12))
    cannot_refract = ratio * sin_theta > 1.0
    must_reflect = cannot_refract | (schlick_reflectance(cos_theta, ratio) > reflect_u)
    refracted = vm.refract(unit_in, normal, ratio)
    diel_dir = torch.where(must_reflect[:, None], reflected, refracted)

    is_lam = rec.mat_type == LAMBERTIAN
    is_metal = rec.mat_type == METAL
    direction = torch.where(is_lam[:, None], lam_dir, torch.where(is_metal[:, None], metal_dir, diel_dir))
    attenuation = torch.where((rec.mat_type == DIELECTRIC)[:, None], torch.ones_like(rec.albedo),
                              rec.albedo)
    scattered_ok = torch.where(is_metal, metal_ok, True)
    return direction, attenuation, scattered_ok
