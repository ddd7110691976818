"""FMA contraction on and off: the kernel's agreement with its plain
version, and its time.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.fma_contraction

Builds `csrc/` twice: with the committed flags (`-fmad=false`) and with
nvcc's default contraction (`-fmad=true`). For each build it prints

- the kernel-vs-plain agreement of one unbudgeted pass from fresh lane
  state at 64x32, depth 8, spp 4 and spp 2, on the reference cover scene;
- the same agreement at the bench preset (cover scene, 1200x800, 10 spp,
  depth 50);
- the time of one unbudgeted bench pass for tiles 128, 256 and 512, by
  CUDA events, mean of 5 after a warm-up;

and the plain version's time for the bench pass. Needs one CUDA GPU and
nvcc; the two libraries go to `build/kernels/`, named by their flags.
"""

from __future__ import annotations

import contextlib
import sys
import time
from unittest import mock

import torch

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import (
    cuda_ms,
    lane_inputs,
    nvidia_smi,
    ptxas_summary,
    small_camera,
)
from ray_tracing_in_one_weekend_tpu_torch.utils import compare
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

CONTRACTED = tuple("-fmad=true" if f == "-fmad=false" else f for f in build.NVCC_FLAGS)
TILES = (128, 256, 512)


@contextlib.contextmanager
def built_with(flags):
    """While open, `build.render_pass` launches a library built with `flags`."""
    with mock.patch.object(build, "NVCC_FLAGS", flags), mock.patch.object(build, "_LIB", None):
        res = build.build()
        build.load()
        yield res


def one_pass(scene, cam, tile=128):
    """(inputs, args) of one unbudgeted pass from fresh lane state."""
    p_mat, cam_vec, sf, si, n = lane_inputs(scene, cam, tile)
    spp, depth = cam.samples_per_pixel, cam.max_depth
    return p_mat, n, (cam_vec, (0, 0, 0, spp * depth), sf, si, tile, spp, depth)


def main() -> int:
    if not torch.cuda.is_available():
        print("fma_contraction: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"{smi} | torch {torch.__version__} | CUDA {torch.version.cuda}", flush=True)

    ref = scene_lib.cover_scene_reference(device=dev)
    small = {spp: one_pass(ref, small_camera(dev, spp=spp)) for spp in (4, 2)}
    config = PRESETS["bench"]
    p_mat, n, args = one_pass(make_scene_from_config(config, dev), make_camera_from_config(config, dev))
    spp = args[-2]
    t0 = time.perf_counter()
    plain_bench = cr._render_pass_plain(p_mat, *args)
    torch.cuda.synchronize()
    print(f"plain version, bench pass: {time.perf_counter() - t0:.3f} s [{smi}]", flush=True)

    for name, flags in (("-fmad=false", build.NVCC_FLAGS), ("-fmad=true", CONTRACTED)):
        with built_with(flags) as res:
            print(f"{name}: nvcc {res.seconds:.1f} s | {ptxas_summary(res.log)}", flush=True)
            for s, (pm, nn, a) in small.items():
                agree = compare.lane_states(
                    *build.render_pass(pm.T.contiguous(), *a), *cr._render_pass_plain(pm, *a), nn, s)
                print(f"{name}: 64x32 spp {s} depth 8 vs plain: {agree}", flush=True)
            table = p_mat.T.contiguous()
            agree = compare.lane_states(*build.render_pass(table, *args), *plain_bench, n, spp)
            print(f"{name}: bench pass vs plain: {agree}", flush=True)
            for tile in TILES:
                targs = args[:-3] + (tile,) + args[-2:]
                build.render_pass(table, *targs)
                ms = cuda_ms(lambda: build.render_pass(table, *targs), reps=5)
                print(f"{name}: bench pass, tile {tile}: {ms:.2f} ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
