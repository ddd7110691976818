"""Render a reference preset through the batched kernel path, and write it
as PNG with a manifest entry.

    python -m ray_tracing_in_one_weekend_tpu_torch.scripts.render_artifact <preset> [spp]
        [--spp-batch N] [--out DIR] [--seed S] [--jax-scene]

The counterpart of the JAX package's scripts/render_artifact.py. The
preset (`utils/config.PRESETS`; `gpu` is 1920x1080, 500 spp, defocus 0.6
degrees, reference: src/gpu/camera.h:58-62) renders in sample batches
through `utils/checkpoint.accumulate`, batches of 100 by default as the
JAX gallery's renders were made, so the float32 fold of the batches is
theirs. The `cpu` preset renders the reference's exact scene
(`cover_scene_reference`), as the JAX gallery does; the others the
preset's `cover_scene(seed)`, or with `--jax-scene` the committed table
of the JAX package's `cover_scene(0)`, the scene of the TPU gallery's
renders. Both packages draw the cover scene from the same threefry keys,
so the two give the same world; the table is how a machine without JAX
checks that they do.

It writes `cover_<W>x<H>_<spp>spp_<preset>.png` (`_seed<S>` added for a
render seed other than the preset's) into `--out` (default
`build/gallery/`) and records the render in `MANIFEST.json` there
(`utils/manifest.py`). Each batch ends in `torch.cuda.synchronize()`.
Every batch runs cold (a new sample window misses the warm cache); the
first also pays first use (the nvcc build, the allocator), so the steady
rate `mrays_per_s` leaves it out, and `mrays_per_s_incl_first` counts
every batch. The default device is the card; without a GPU it raises
unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_in_one_weekend_tpu_torch.utils import manifest
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)
from ray_tracing_in_one_weekend_tpu_torch.utils.png import write_png

OUT_DIR = os.path.join(manifest.repo_root(), "build", "gallery")
# The JAX package's cover_scene(0) (ray_tracing_in_one_weekend_tpu/models/
# scene.py), all 512 slots: the scene of the TPU gallery's gpu, gpu-old and
# cpu-mt renders. tests/test_torch_gallery.py holds it equal to the JAX
# function's arrays, and tests/test_torch_threefry.py and chip_smoke.py to
# the port's cover_scene(0).
JAX_COVER_SCENE_0 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_cover_scene_0.npz")


@dataclasses.dataclass(frozen=True)
class Artifact:
    name: str  # file name in out_dir
    path: str
    image: torch.Tensor  # [H, W, 3] float32, the linear mean on the render's device
    u8: np.ndarray  # [H, W, 3] the pixels written
    entry: dict  # its manifest entry
    batch_s: tuple  # seconds a batch, each to its synchronize
    launches: tuple  # render_kernel launches a batch (0 on the CPU)


def steady_rates(batch_s, rays) -> dict:
    """Mrays/s of a batched render from each batch's seconds and rays:
    `mrays_per_s_incl_first` over every batch, and `mrays_per_s`, the
    steady rate, over the batches after the first. One batch has no steady
    window, and then only the first is given."""
    rates = {"mrays_per_s_incl_first": sum(rays) / sum(batch_s) / 1e6}
    if len(batch_s) > 1:
        rates["mrays_per_s"] = sum(rays[1:]) / sum(batch_s[1:]) / 1e6
    return rates


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def preset_scene(preset: str, config, device, jax_scene: bool = False):
    """(scene, its label for the manifest) of a preset: the reference's exact
    scene for `cpu`; else the committed table of the JAX package's
    cover_scene(0) with `jax_scene` (the same arrays as the port's
    cover_scene(0)), or the preset's own scene."""
    if preset == "cpu":
        return scene_lib.cover_scene_reference(device=device), "cover_scene_reference"
    if jax_scene:
        if config.scene != "cover" or config.seed != 0:
            raise ValueError(f"the JAX scene is held for cover_scene(0) only, not {config.scene} "
                             f"seed {config.seed}")
        with np.load(JAX_COVER_SCENE_0) as z:
            arrays = {k: z[k] for k in z.files}
        return scene_lib.scene_from_numpy(arrays, device=device), "jax cover_scene(0)"
    label = f"cover_scene({config.seed})" if config.scene == "cover" else config.scene
    return make_scene_from_config(config, device), label


def render_preset(preset: str, spp: int | None = None, spp_batch: int = 100, out_dir: str = OUT_DIR,
                  seed: int | None = None, device="cuda", jax_scene: bool = False,
                  **changes) -> Artifact:
    """Render `PRESETS[preset]` (with the RenderConfig fields in `changes`
    replaced: a smaller render) to `spp` samples in batches of `spp_batch`
    under render seed `seed` (default the preset's), write the PNG into
    `out_dir` and record it in the manifest there."""
    device = scene_lib.resolve_device(device)
    config = dataclasses.replace(PRESETS[preset], **changes)
    spp = config.samples_per_pixel if spp is None else spp
    seed = config.seed if seed is None else seed
    if spp < 1 or spp_batch < 1:
        raise ValueError(f"spp ({spp}) and spp_batch ({spp_batch}) must be >= 1")
    scene, scene_label = preset_scene(preset, config, device, jax_scene)
    cam = make_camera_from_config(config, device)
    w, h = cam.image_width, cam.image_height
    log(f"artifact[{preset}]: {w}x{h} spp={spp} depth={cam.max_depth} seed={seed} "
        f"scene={scene_label} device={device}")

    state = ckpt.new_state(cam, device)
    batch_s, launches, rays = [], [], []
    while state.spp_done < spp:
        n = min(spp_batch, spp - state.spp_done)
        before = build.LAUNCHES["render_kernel"]
        t0 = time.perf_counter()
        state = ckpt.accumulate(state, scene, cam, seed, n)
        if device.type == "cuda":
            torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        launches.append(build.LAUNCHES["render_kernel"] - before)
        rays.append(w * h * n)
        log(f"artifact[{preset}]: samples {state.spp_done}/{spp} (+{n} in {batch_s[-1]:.3f}s)")
    u8 = to_uint8(state.image).cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    name = f"cover_{w}x{h}_{spp}spp_{preset}" + (f"_seed{seed}" if seed != config.seed else "") + ".png"
    path = os.path.join(out_dir, name)
    write_png(u8, path)
    rates = steady_rates(batch_s, rays)
    entry = manifest.record(out_dir, name, {
        "preset": preset,
        "scene": scene_label,
        "width": w, "height": h, "spp": spp,
        "max_depth": cam.max_depth,
        "seed": seed,
        "backend": "cuda" if device.type == "cuda" else "torch",
        "render_seconds": sum(batch_s),
        **rates,
        "batch_seconds": batch_s,
        "render_kernel_launches": sum(launches),
        "mean_u8": float(u8.mean()),
    }, device=str(device))
    steady = (f"{rates['mrays_per_s']:.2f} Mrays/s steady, " if "mrays_per_s" in rates else "")
    log(f"artifact[{preset}]: {name} in {sum(batch_s):.3f}s ({steady}"
        f"{rates['mrays_per_s_incl_first']:.2f} incl the first batch), mean {u8.mean():.3f}")
    return Artifact(name, path, state.image, u8, entry, tuple(batch_s), tuple(launches))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="gpu", choices=sorted(PRESETS))
    ap.add_argument("spp", nargs="?", type=int, default=None, help="samples a pixel (default: the preset's)")
    ap.add_argument("--spp-batch", type=int, default=100)
    ap.add_argument("--out", default=OUT_DIR, help="directory of the PNG and its MANIFEST.json")
    ap.add_argument("--seed", type=int, default=None, help="render seed (default: the preset's)")
    ap.add_argument("--jax-scene", action="store_true",
                    help="render the JAX package's cover_scene(0), the TPU gallery's scene")
    args = ap.parse_args(argv)
    render_preset(args.preset, args.spp, args.spp_batch, args.out, args.seed, jax_scene=args.jax_scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
