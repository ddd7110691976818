"""Command-line renderer: PPM to stdout, logs to stderr.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/cli.py,
with the same flag names and meanings (the reference's whole CLI contract
is `./main > out.ppm`, reference: script/windows/rt-utility.psm1:33-47):

    python -m ray_tracing_in_one_weekend_tpu_torch --preset bench > out.ppm
    python -m ray_tracing_in_one_weekend_tpu_torch --backend torch --width 200 > out.ppm

Backends: `cuda` (the default) runs the hand-written kernel on the first
GPU, and raises when there is none; `torch` runs the plain PyTorch
version on the CPU, and only when asked for.

The render is timed the way the reference times it: wall clock around
the render only (reference: src/gpu/main.cu:128-139), after one warm-up
render, with `torch.cuda.synchronize()` as the barrier on the GPU.
Mrays/s = width * height * spp / render seconds / 1e6. The warm-up render
fills the warm-start cache, so the timed render runs the warm schedule
(one pass over cost-sorted lanes) unless `--cold` is given, as in the JAX
CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    DEFAULT_TILE,
    render_cuda,
    warm_cache_hit,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
from ray_tracing_in_one_weekend_tpu_torch.utils import ppm
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    BACKENDS,
    PRESETS,
    RenderConfig,
    make_camera_from_config,
    make_scene_from_config,
)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p =argparse.ArgumentParser(
        prog="ray_tracing_in_one_weekend_tpu_torch",
        description="Path tracer on PyTorch + a hand-written CUDA kernel (PPM to stdout).",
    )
    d = RenderConfig()
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="start from a reference workload preset")
    p.add_argument("--width", type=int, default=None, help=f"image width (default {d.image_width})")
    p.add_argument("--aspect", type=float, default=None, help="aspect ratio w/h")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=None, help="bounce limit")
    p.add_argument("--vfov", type=float, default=None, help="vertical fov, degrees")
    p.add_argument("--lookfrom", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--lookat", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--vup", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--defocus-angle", type=float, default=None,
                   help="defocus cone angle, degrees (0 = pinhole)")
    p.add_argument("--aperture", type=float, default=None,
                   help="CPU-tree lens aperture (overrides --defocus-angle)")
    p.add_argument("--focus-dist", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scene", choices=("cover", "three", "single"), default=None)
    p.add_argument("--tile", type=int, default=DEFAULT_TILE,
                   help=f"lanes per CUDA block, a multiple of 128 (default {DEFAULT_TILE})")
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="cuda (default): the kernel on the GPU; torch: the plain version on the CPU")
    p.add_argument("--cold", action="store_true",
                   help="disable warm-start scheduling: every render runs the cold multi-pass "
                        "compaction schedule instead of reusing the cached cost-sorted lane "
                        "permutation (bit-identical image either way)")
    p.add_argument("--out", default="-", help="output PPM path ('-' = stdout)")
    p.add_argument("--no-output", action="store_true", help="render + report timing only")
    return p


def config_from_args(args) -> RenderConfig:
    config = PRESETS[args.preset] if args.preset else RenderConfig()
    mapping = {
        "width": "image_width",
        "aspect": "aspect_ratio",
        "spp": "samples_per_pixel",
        "max_depth": "max_depth",
        "vfov": "vfov_degrees",
        "lookfrom": "lookfrom",
        "lookat": "lookat",
        "vup": "vup",
        "defocus_angle": "defocus_angle_degrees",
        "aperture": "aperture",
        "focus_dist": "focus_dist",
        "seed": "seed",
        "scene": "scene",
        "backend": "backend",
    }
    updates = {}
    for arg_name, field in mapping.items():
        v = getattr(args, arg_name)
        if v is not None:
            updates[field] = tuple(v) if isinstance(v, list) else v
    return dataclasses.replace(config, **updates)


def resolve_backend(backend: str) -> str:
    """`cuda` without a GPU raises: the CLI never falls back to the CPU."""
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--backend cuda needs a CUDA GPU, and torch sees none "
                           "(--backend torch runs the plain version on the CPU)")
    return backend


@dataclasses.dataclass(frozen=True)
class CliResult:
    config: RenderConfig
    backend: str
    image: torch.Tensor  # [H, W, 3] float32, linear, on the render device
    first_s: float  # first render, kernel build included
    render_s: float  # the timed (second) render
    warm_hit: bool  # the timed render ran the cached warm schedule

    @property
    def mrays_per_s(self) -> float:
        return self.config.rays_per_frame / self.render_s / 1e6


def run(argv=None) -> CliResult:
    """Parse `argv`, render, time, and write the PPM (unless --no-output)."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    backend = resolve_backend(config.backend)
    device = torch.device("cuda", 0) if backend == "cuda" else torch.device("cpu")
    _log(f"renderer: {config.image_width}x{config.image_height} "
         f"spp={config.samples_per_pixel} depth={config.max_depth} "
         f"scene={config.scene} seed={config.seed}")
    device_name = torch.cuda.get_device_name(device) if backend == "cuda" else "cpu"
    _log(f"backend: {backend} on {device_name}")

    scene = make_scene_from_config(config, device)
    cam = make_camera_from_config(config, device)

    def render():
        img = render_cuda(scene, cam, seed=config.seed, tile=args.tile, warm=not args.cold)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return img

    t0 = time.perf_counter()
    render()
    first_s = time.perf_counter() - t0
    _log(f"first render (kernel build included): {first_s:.2f}s")
    warm_hit = not args.cold and warm_cache_hit(scene, cam, seed=config.seed, tile=args.tile)
    t0 = time.perf_counter()
    img = render()
    render_s = time.perf_counter() - t0
    result = CliResult(config, backend, img, first_s, render_s, warm_hit)
    _log(f"render: {render_s:.3f}s  ({result.mrays_per_s:.2f} Mrays/s, "
         f"{'warm' if warm_hit else 'cold'} schedule)")

    if not args.no_output:
        u8 =to_uint8(img).cpu().numpy()
        if args.out == "-":
            ppm.write_ppm(u8, sys.stdout.buffer)
            sys.stdout.buffer.flush()
        else:
            ppm.write_ppm(u8, args.out)
            _log(f"wrote {args.out}")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
