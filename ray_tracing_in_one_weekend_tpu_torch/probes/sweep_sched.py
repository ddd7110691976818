"""Sweep the lane scheduler's knobs (tile, budget, passes) on the bench
preset, and print the render time of each configuration.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.sweep_sched [tile:budget:passes ...]

The counterpart of the JAX package's scripts/sweep_sched.py, over the
cold schedule (`warm=False`: no schedule cache, `n_passes` passes with
tail compaction, every pass but the last stopped at `budget` iterations)
of the bench preset (the cover scene, 1200x800, 10 spp, depth 50). Each
configuration renders once untimed, then REPS times, each render ended by
`torch.cuda.synchronize()`; one line a configuration gives the best
seconds, Mrays/s and render_kernel launches a render, and the last line
the best configuration. Scheduling never changes a pixel
(`ops/cuda_render._multipass`): every configuration's image must be
`torch.equal` to the default schedule's, or the sweep raises.

The port's tiles are thread blocks, multiples of 128 (the default 128);
the JAX grid's tiles (1024-4096 lanes) are TPU block widths. It needs one
CUDA GPU with nvcc.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

REPS = 3
# scripts/sweep_sched.py:42-51's (budget, passes) pairs, here at tiles 128
# and 256; then the budgets around the default's 3 spp at the default 2
# passes. The first entry is the default schedule at the bench preset:
# DEFAULT_TILE, _default_budget(10) = 30, DEFAULT_PASSES.
JAX_PAIRS = ((30, 3), (20, 4), (15, 5), (12, 6), (25, 3))
DEFAULT_GRID = (
    (cr.DEFAULT_TILE, 30, cr.DEFAULT_PASSES),
    *((tile, budget, passes) for tile in (128, 256) for budget, passes in JAX_PAIRS),
    *((cr.DEFAULT_TILE, budget, cr.DEFAULT_PASSES) for budget in (15, 20, 45)),
)


def parse_config(text: str) -> tuple:
    """"tile:budget:passes" -> (tile, budget, passes); raises ValueError on
    anything else: a tile that is not a positive multiple of 128, a budget
    or passes below 1."""
    parts = text.split(":")
    if len(parts) != 3:
        raise ValueError(f"{text!r} is not tile:budget:passes")
    tile, budget, passes = (int(p) for p in parts)
    cr._check_tile(tile)
    if budget < 1 or passes < 1:
        raise ValueError(f"{text!r}: budget ({budget}) and passes ({passes}) must be >= 1")
    return tile, budget, passes


@dataclasses.dataclass(frozen=True)
class Result:
    tile: int
    budget: int
    passes: int
    first_s: float  # the untimed first render
    times_s: tuple  # the REPS timed renders
    mrays_per_s: float  # at the best time
    launches: float  # render_kernel launches a render

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    def line(self) -> str:
        return (f"tile={self.tile} budget={self.budget} passes={self.passes}: best {self.best_s * 1e3:.3f} ms "
                f"({self.mrays_per_s:.2f} Mrays/s), times " + ", ".join(f"{t * 1e3:.3f}" for t in self.times_s)
                + f" ms, first {self.first_s * 1e3:.3f} ms, render_kernel launches {self.launches:g} a render")


def _timed_render(scene, cam, seed, tile, budget, passes):
    t0 = time.perf_counter()
    img = cr.render_cuda(scene, cam, seed=seed, tile=tile, budget=budget, n_passes=passes, warm=False)
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    return img, time.perf_counter() - t0


def sweep(scene, cam, configs=DEFAULT_GRID, reps=REPS, seed=0) -> list:
    """Render `cam` of `scene` cold under each (tile, budget, passes) of
    `configs`, once untimed and `reps` times timed, on the scene's device.
    Raises when an image differs from the default schedule's."""
    default = cr.render_cuda(scene, cam, seed=seed, warm=False)
    rays = cam.num_pixels * cam.samples_per_pixel
    results = []
    for tile, budget, passes in configs:
        before = build.LAUNCHES["render_kernel"]
        times = []
        for _ in range(1 + reps):
            img, t = _timed_render(scene, cam, seed, tile, budget, passes)
            if not torch.equal(img, default):
                raise RuntimeError(f"tile={tile} budget={budget} passes={passes} changed the image")
            times.append(t)
        launches = (build.LAUNCHES["render_kernel"] - before) / (1 + reps)
        results.append(Result(tile, budget, passes, times[0], tuple(times[1:]), rays / min(times[1:]) / 1e6,
                              launches))
    return results


def main(argv=None) -> int:
    from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    argv = sys.argv[1:] if argv is None else argv
    configs = [parse_config(a) for a in argv] or list(DEFAULT_GRID)
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config), make_camera_from_config(config)
    results = sweep(scene, cam, configs)
    for r in results:
        print(r.line(), flush=True)
    best = min(results, key=lambda r: r.best_s)
    print(f"every image equal to the default schedule's; best: tile={best.tile} budget={best.budget} "
          f"passes={best.passes} {best.best_s * 1e3:.3f} ms ({best.mrays_per_s:.2f} Mrays/s) [{nvidia_smi()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
