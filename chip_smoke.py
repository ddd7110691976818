"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernel from
`ray_tracing_in_one_weekend_tpu_torch/csrc/` with nvcc (into the ignored
`build/kernels/`), checks the kernel against its plain PyTorch version on
the card, and drives the port's main path — the CLI at the bench preset:
the cover scene, 1200x800, 10 spp, depth 50 — through the kernel.

Phases, one line each; any failure raises and the script exits non-zero
without the result lines:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: nvcc, timed, with ptxas' register report;
3. kernel vs plain, one pass from identical lane state (64x32, spp 4,
   depth 8, tile 128, the reference cover scene): at most 2% flipped
   lanes, 256-lane block-mean MAD < 0.02 and mean difference < 0.01;
4. sky only (every sphere inactive) equal to the plain version to 1e-6,
   and NaN-as-miss: rays aimed away from every sphere all see the sky;
5. n_passes=3, budget=3 bit-identical to one pass;
6. the main path: the CLI at full width through the kernel (launch count
   > 0, P3 header, finite pixels, render seconds and Mrays/s); the kernel
   against the plain version at the main path's shapes (times; the lane
   states must be bit-identical, as the build without FMA contraction
   makes them); and the 150x100 CLI render against the plain version
   (bit-identical, and block means as in phase 3).

Then it prints nvidia-smi's line, a JSON line of per-kernel results, and
last `{"ok": true, "device": {...}}`. It imports no JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "ray_tracing_in_one_weekend_tpu_torch"
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(line: str) -> None:
    print(line, flush=True)


def phase_kernel_vs_plain(scene, cam, label):
    """One kernel pass and one plain pass from identical lane state: first a
    budgeted pass (3 iterations) from fresh state, then an unbudgeted pass
    from where it stopped."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
    from ray_tracing_in_one_weekend_tpu_torch.probes import lane_inputs
    from ray_tracing_in_one_weekend_tpu_torch.utils import compare

    spp, depth = cam.samples_per_pixel, cam.max_depth
    p_mat, cam_vec, sf, si, n = lane_inputs(scene, cam)
    table = p_mat.T.contiguous()
    results = []
    for budget in (3, spp * depth):
        args = (cam_vec, (0, 0, 0, budget), sf, si, 128, spp, depth)
        of_k, oi_k = build.render_pass(table, *args)
        of_p, oi_p = cr._render_pass_plain(p_mat, *args)
        torch_sync()
        agree = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
        check(agree.flipped_frac <= 0.02,
              f"{label}: {agree.flipped_frac:.2%} of lanes flipped (budget {budget}), limit 2%")
        check(agree.blocks_agree, f"{label}: block means disagree (budget {budget}): {agree}")
        results.append(agree)
        sf, si = of_p, oi_p
    return results


def torch_sync():
    import torch

    torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found next to this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    from ray_tracing_in_one_weekend_tpu_torch.utils import cli, compare, ppm
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    # 1. card
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 card: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | {kind}")

    # 2. build
    res = build.build()
    build.load()
    say(f"phase 2 build: {res.seconds:.1f}s nvcc into {res.path.relative_to(REPO)} | "
        f"{ptxas_summary(res.log)}")

    # 3. kernel vs plain, one pass
    ref = scene_lib.cover_scene_reference(device=DEVICE)
    a_budget, a_full = phase_kernel_vs_plain(ref, small_camera(DEVICE), "phase 3")
    say(f"phase 3 kernel vs plain (64x32, spp 4, depth 8): flipped lanes "
        f"{a_budget.flipped_frac:.4%} (budget 3), {a_full.flipped_frac:.4%} (to the end); "
        f"block MAD {a_full.block_mad:.2e}, mean diff {a_full.mean_diff:.2e}")

    # 4. sky only, and NaN-as-miss
    cam = small_camera(DEVICE)
    sky = ref.replace(active=torch.zeros_like(ref.active))
    img_k = cr.render_cuda(sky, cam)
    img_p = cr.render_with(cr._render_pass_plain, sky, cam)
    sky_err = float((img_k - img_p).abs().max())
    check(sky_err <= 1e-6, f"phase 4: sky-only image differs from plain by {sky_err}")
    up = small_camera(DEVICE, lookfrom=(0.0, 50.0, 0.0), lookat=(0.0, 100.0, 0.0), vup=(1.0, 0.0, 0.0))
    p_mat = cr.pack_scene(ref)
    check(bool((p_mat[cr._R2][~ref.active] == -1.0).all()), "phase 4: padding slots not at r^2 = -1")
    img, work = cr.render_cuda(ref, up, return_work=True)
    check(bool(torch.isfinite(img).all()), "phase 4: non-finite pixels on sky-bound rays")
    check(bool((work == up.samples_per_pixel).all()),
          "phase 4: a ray aimed away from every sphere hit one (work != spp)")
    check(float((img[..., 2] - 1.0).abs().max()) < 1e-5, "phase 4: sky-bound pixel is not sky blue")
    say(f"phase 4 sky: sky-only max diff {sky_err:.1e}; {img.shape[0] * img.shape[1]} pixels of "
        f"upward rays all sky (one bounce per sample), finite")

    # 5. passes
    one = cr.render_cuda(ref, cam, n_passes=1)
    three = cr.render_cuda(ref, cam, n_passes=3, budget=3)
    check(torch.equal(one, three), "phase 5: n_passes=3, budget=3 differs from one pass")
    say("phase 5 passes: n_passes=3 budget=3 bit-identical to n_passes=1")

    # 6. the main path
    out = REPO / "build" / "smoke.ppm"
    out.parent.mkdir(parents=True, exist_ok=True)
    build.reset_launches()
    run = cli.run(["--preset", "bench", "--backend", "cuda", "--out", str(out)])
    launches = dict(build.LAUNCHES)
    check(launches["render_kernel"] > 0, "phase 6: the CLI never launched render_kernel")
    check(run.backend == "cuda", f"phase 6: CLI ran backend {run.backend}")
    check(out.read_bytes().startswith(b"P3\n1200 800\n255\n"), "phase 6: bad PPM header")
    check(ppm.read_ppm(str(out)).shape == (800, 1200, 3), "phase 6: bad PPM size")
    check(bool(torch.isfinite(run.image).all()), "phase 6: non-finite pixels")

    # The kernel against the plain version at the main path's shapes.
    config = PRESETS["bench"]
    scene = make_scene_from_config(config, DEVICE)
    cam = make_camera_from_config(config, DEVICE)
    spp, depth = cam.samples_per_pixel, cam.max_depth
    p_mat, cam_vec, sf, si, n = lane_inputs(scene, cam)
    table = p_mat.T.contiguous()
    args = (cam_vec, (0, 0, 0, spp * depth), sf, si, 128, spp, depth)
    of_k, oi_k = build.render_pass(table, *args)
    kernel_ms = cuda_ms(lambda: build.render_pass(table, *args), reps=5)
    t0 = time.perf_counter()
    of_p, oi_p = cr._render_pass_plain(p_mat, *args)
    torch_sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    full = compare.lane_states(of_k, oi_k, of_p, oi_p, n, spp)
    # Built without FMA contraction, the kernel rounds every operation as the
    # plain version does, so at the main path's shapes the two are identical.
    check(full.blocks_agree, f"phase 6: kernel vs plain at full width: {full}")
    check(full.flipped_frac == 0.0 and full.max_abs_err == 0.0,
          f"phase 6: kernel vs plain at full width not bit-identical: {full}")

    small = cli.run(["--preset", "bench", "--width", "150", "--backend", "cuda", "--no-output"])
    cam150 = make_camera_from_config(small.config, DEVICE)
    plain150 = cr.render_with(cr._render_pass_plain, scene, cam150)
    a150 = compare.images(small.image, plain150, block=10)
    check(a150.blocks_agree, f"phase 6: 150x100 CLI vs plain: {a150}")
    check(a150.flipped_frac == 0.0 and a150.max_abs_err == 0.0,
          f"phase 6: 150x100 CLI vs plain not bit-identical: {a150}")
    mean_gap = abs(float(run.image.mean()) - float(plain150.mean()))
    check(mean_gap < 0.02, f"phase 6: full-width mean is {mean_gap:.4f} off the 150x100 plain mean")
    c = run.config
    say(f"phase 6 main path: bench {c.image_width}x{c.image_height} spp {c.samples_per_pixel} "
        f"depth {c.max_depth} via CLI, {launches['render_kernel']} "
        f"launch(es); render {run.render_s:.4f}s = {run.mrays_per_s:.2f} Mrays/s "
        f"(first {run.first_s:.2f}s); kernel pass {kernel_ms:.2f} ms vs plain {plain_ms:.0f} ms "
        f"[{smi}]; full-width flipped {full.flipped_frac:.4%}, max lane err "
        f"{full.max_abs_err:.2e}, block MAD {full.block_mad:.2e}; "
        f"150x100 vs plain max pixel err {a150.max_abs_err:.2e}, block MAD {a150.block_mad:.4f}, "
        f"mean diff {a150.mean_diff:.4f}; "
        f"mean gap {mean_gap:.4f}")

    check("jax" not in sys.modules and "flax" not in sys.modules, "JAX was imported")
    say(smi)
    say(json.dumps({"kernels": [{
        "name": "render_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/render_kernel.cu",
        "replaces": "ray_tracing_in_one_weekend_tpu/ops/pallas_render.py:477",
        "launches": launches["render_kernel"],
        "max_abs_err": full.max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "tolerance": "max_abs_err: largest per-lane radiance difference of one bench pass; "
                     "gates: bit-identical lane state at full width (0 flipped lanes, "
                     "max_abs_err 0) and a bit-identical 150x100 CLI image; at 64x32 spp 4, "
                     "flipped lanes (|d| > 1e-4 or an integer row differs) <= 2% and 256-lane "
                     "block means MAD < 0.02, mean diff < 0.01",
        "flipped_frac": full.flipped_frac,
        "block_mad": full.block_mad,
        "render_s": run.render_s,
        "mrays_per_s": run.mrays_per_s,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
