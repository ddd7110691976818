"""The jnp backend's forward: the hand-written kernel and its plain version.

The JAX package's jnp path (ops/render.py::render_image ->
ops/integrator.py::trace_rays, XLA-fused, no Pallas kernel) on the
port's threefry keys. `render_kernel_pixels` renders any flat batch of
global pixel ids of a CUDA scene by `csrc/threefry_render_kernel.cu`
through `kernels.build.threefry_render`, which raises if it cannot: a
persistent grid whose threads take the pixels from a queue counter on the
card, one pixel at a time, and sweep the scene in groups of tests with
one sign test a group (see the kernel's source note). A pixel's value and
its count of sweeps depend only on its global id, so any order of
`pixel_indices` gives the same bits. The kernel's plain version is
`ops/render.render_flat_threefry` (its `return_work` counts the sweeps as
the kernel does); `ops/render.render_keyed` chooses between the two by the
scene's device, with no fallback from one to the other.

The kernel and the plain version compute the same operations in the same
order (the fused multiply-adds the plain version computes exactly), so on
the card they agree bit for bit where the render kernel and its plain
version do; against the JAX package on the CPU they agree to float32
rounding per bounce (tests/test_torch_jnp_render.py holds the gates).
"""

from __future__ import annotations

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import pack_camera, pack_scene
from ray_tracing_in_one_weekend_tpu_torch.ops.threefry import as_key


def render_kernel_pixels(scene: Scene, cam: Camera, pixel_indices, base_key=0, spp: int | None = None,
                         sample_offset: int = 0, return_work: bool = False):
    """The kernel on a CUDA scene -> [R, 3] (and, with `return_work`, the
    [R] sweeps each pixel ran). Raises for a scene on another device."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    spp = cam.samples_per_pixel if spp is None else spp
    pix = torch.as_tensor(pixel_indices, device=scene.device).reshape(-1).to(torch.int32).contiguous()
    return build.threefry_render(
        pack_scene(scene).T.contiguous(), pack_camera(cam).to(scene.device), pix, as_key(base_key),
        sample_offset, spp, cam.max_depth, work=return_work,
    )

