"""Numerical-health guards.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/debug.py.
The reference's only runtime checking is the fail-stop `checkCudaErrors`
macro (reference: src/gpu/cuda_utility.h:8-18), and it has no NaN
detection at all. These guards are for tests and debugging runs; the
production paths stay guard-free.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    DEFAULT_TILE,
    pack_camera,
    render_cuda,
)

_SCENE_FLOATS = ("center", "radius", "albedo", "fuzz", "ior")


@dataclasses.dataclass(frozen=True)
class RenderError:
    """The faults `checked_render` found (empty when there were none), with
    the `get` / `throw` of a JAX checkify error."""

    messages: tuple[str, ...] = ()

    def get(self) -> str | None:
        return "; ".join(self.messages) if self.messages else None

    def throw(self) -> None:
        if self.messages:
            raise FloatingPointError(self.get())


def _nonfinite(x: torch.Tensor) -> int:
    return int((~torch.isfinite(x)).sum())


def checked_render(scene: Scene, cam: Camera, seed: int, tile: int = DEFAULT_TILE):
    """Render with float-fault checking: returns (error, image).

    `error.throw()` raises if a check failed. The render is `render_cuda`
    on the scene's device (the kernel on the card), and the checks run on
    what goes in and what comes out: the float fields of the scene's
    active slots, the packed camera, the image and the per-pixel work map.

    What it covers against the JAX package's `checkify` form: checkify
    sees a NaN produced by any operation inside the render, which the
    kernel does not report. The kernel treats a NaN intersection as a
    miss, so a scene with a NaN center can render a finite image; the
    input checks catch it here, where checkify catches the NaN the
    intersection test makes of it. A NaN that arises inside the kernel
    from finite inputs shows here only if it reaches the image or the
    work map. Inactive slots are not checked: the render never reads
    them (pack_scene makes them unhittable).
    """
    msgs = []
    act = scene.active
    for f in _SCENE_FLOATS:
        bad = _nonfinite(getattr(scene, f)[act])
        if bad:
            msgs.append(f"{bad} non-finite values in scene.{f} (active slots)")
    bad = _nonfinite(pack_camera(cam))
    if bad:
        msgs.append(f"{bad} non-finite values in the packed camera")
    img, work = render_cuda(scene, cam, seed=seed, tile=tile, return_work=True)
    for name, x in (("framebuffer", img), ("work map", work)):
        bad = _nonfinite(x)
        if bad:
            msgs.append(f"{bad} non-finite values in the {name}")
    return RenderError(tuple(msgs)), img


def _leaves(obj, path: str):
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finiteness assert over the float tensors in dicts, lists,
    tuples and dataclasses (a Scene, a Camera) (test helper). The message
    names the first leaf at fault by its path, e.g. params['albedo']."""
    for path, leaf in _leaves(tree, ""):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"non-finite values in {name}{path}")
