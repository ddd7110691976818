"""Forward-kernel performance probe: occupancy and the sweep roofline.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.perf_probe [tile] [budget] [n_passes]

The port of the JAX package's scripts/perf_probe.py together with the
occupancy row of its bench.py (`_occupancy_probe`). At the bench preset
(cover scene, 1200x800, 10 spp, depth 50) it reports:

* pass by pass under the cold compaction schedule (`n_passes`, default
  `DEFAULT_PASSES`, `budget` default max(16, 3 spp)): the live lanes, the
  lane-iterations and warp-iterations executed and the unfinished lanes;
* occupancy in the card's own unit. A warp runs until its longest lane is
  done, so the warp-iterations executed are the sum over warps of the
  largest `_SF_ITERS` among its 32 lanes (the port's `_SF_ITERS` is per
  lane), and the ideal is sum(`_SF_WORK`) / 32: every lane-iteration
  packed into full warps. For the cold schedule, one pass in pixel order,
  and one pass over the warm cost-sorted lanes;
* the render times of the three schedules (best of 3, after a warm-up);
* the sweep roofline, the forward kernel's bound: sum(`_SF_WORK`) x sphere
  slots x the float32 operations of one sphere test in `closest_hit`,
  over 67 TFLOP/s and over the rate the fma-peak probe measures;
* the chain probe of the script (`_vpu_peak_ops`): one dependent chain of
  512 fused steps per element on [128, tile] blocks, 64 launches. It is a
  chain rate, not the peak: the roofline takes the fma-peak probe's.

The last line is the script's JSON line with the warp-level fields added.
It needs one CUDA GPU with nvcc.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp

WARP = 32
CHAIN_REPS = 64  # launches of the chain probe (scripts/perf_probe.py:45)
CHAIN_TILE = kp.JAX_TILE


def warp_iters(iters: torch.Tensor) -> float:
    """Warp-iterations executed in one pass: the sum over each 32 lanes of
    the largest per-lane trip count `iters` [P] (P a multiple of 32)."""
    return float(iters.reshape(-1, WARP).amax(dim=1).double().sum())


def ideal_warp_iters(work: torch.Tensor) -> float:
    """The fewest warp-iterations that could run the lane-iterations `work`
    [P] (cumulative `_SF_WORK`): all of them packed into full warps."""
    return float(work.double().sum()) / WARP


def _pass(scene_args, sf, si, budget, tile):
    p_mat, cam_vec, spp, depth = scene_args
    return cr._render_pass(p_mat, cam_vec, (0, 0, 0, budget), sf, si, tile, spp, depth)


def schedules(scene, cam, tile=cr.DEFAULT_TILE, budget=None, n_passes=cr.DEFAULT_PASSES, log=print):
    """Lane- and warp-iterations of the three schedules of one render
    (seed 0): the cold compaction schedule pass by pass, one pass in pixel
    order, and one pass over the lanes sorted by the pixel-order pass's
    cost map (the warm schedule). Runs on the scene's device."""
    spp, depth = cam.samples_per_pixel, cam.max_depth
    budget = cr._default_budget(spp) if budget is None else budget
    n = cam.num_pixels
    padded = -(-n // tile) * tile
    args = (cr.pack_scene(scene), cr.pack_camera(cam).to(scene.device), spp, depth)
    out = {"passes": []}

    sf, si = cr._init_state(0, padded, n, spp, scene.device)
    for p in range(n_passes):
        b = budget if p < n_passes - 1 else spp * depth
        sf, si = _pass(args, sf, si, b, tile)
        iters = sf[cr._SF_ITERS]
        unfinished = (si[cr._SI_BUSY] > 0) | (si[cr._SI_STARTED] < spp)
        row = dict(budget=b, live_lanes=int((iters > 0).sum()), lane_iters=float(iters.double().sum()),
                   warp_iters=warp_iters(iters), max_iters=float(iters.max()),
                   unfinished=int(unfinished.sum()))
        out["passes"].append(row)
        log(f"pass {p}: budget={b} live_lanes={row['live_lanes']}/{padded} "
            f"lane_iters={row['lane_iters']:.0f} warp_iters={row['warp_iters']:.0f} "
            f"(max {row['max_iters']:.0f}) unfinished_lanes={row['unfinished']}/{padded}")
        if p < n_passes - 1:
            sf, si, _ = cr._compact(sf, si, tile, spp)
    out["work"] = float(sf[cr._SF_WORK].double().sum())
    out["ideal"] = ideal_warp_iters(sf[cr._SF_WORK])
    out["cold"] = sum(r["warp_iters"] for r in out["passes"])

    sf, si = cr._init_state(0, padded, n, spp, scene.device)
    sf, si = _pass(args, sf, si, spp * depth, tile)
    out["pixel"] = warp_iters(sf[cr._SF_ITERS])
    work = sf[cr._SF_WORK].clone()

    perm = cr._perm_from_hint(work).reshape(2, padded)[0]
    sf, si = cr._init_state(0, padded, n, spp, scene.device)
    sf, si = _pass(args, sf[:, perm], si[:, perm], spp * depth, tile)
    out["warm"] = warp_iters(sf[cr._SF_ITERS])
    for key in ("cold", "pixel", "warm"):
        out[f"occupancy_{key}"] = out["ideal"] / max(out[key], 1.0)
    if float(work.double().sum()) != out["work"]:
        raise RuntimeError("the schedules did different work: the lane-iterations must not depend on order")
    return out


def render_seconds(scene, cam, tile, reps=3, **kw) -> float:
    """Best of `reps` timed renders after one warm-up, each ended by a
    synchronize (the CLI's protocol)."""
    cr.render_cuda(scene, cam, tile=tile, **kw)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        cr.render_cuda(scene, cam, tile=tile, **kw)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def chain_rate(tile: int = CHAIN_TILE, launches: int = CHAIN_REPS) -> float:
    """Operations per second of the chain probe: `launches` launches in
    series on [128, tile] (x = f(x)), 2 operations per fused step."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms

    xs = list(kp.inputs("chain_fma", tile, torch.device("cuda", 0)))
    kp.chain_fma(xs[0])

    def step():
        xs[0] = kp.chain_fma(xs[0])

    return 2.0 * xs[0].numel() * kp.CHAIN / (cuda_ms(step, reps=launches) * 1e-3)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("perf_probe measures the card: it needs a CUDA GPU")
    from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    dev = torch.device("cuda", 0)
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    spp = cam.samples_per_pixel
    tile = int(argv[0]) if len(argv) > 0 else cr.DEFAULT_TILE
    budget = int(argv[1]) if len(argv) > 1 else cr._default_budget(spp)
    n_passes = int(argv[2]) if len(argv) > 2 else cr.DEFAULT_PASSES
    smi = nvidia_smi()

    def log(line):
        print(line, file=sys.stderr, flush=True)

    s = schedules(scene, cam, tile, budget, n_passes, log=log)
    rays = cam.num_pixels * spp
    cr._WORK_CACHE.clear()
    t_cold = render_seconds(scene, cam, tile, n_passes=n_passes, budget=budget, warm=False)
    t_pixel = render_seconds(scene, cam, tile, n_passes=1, warm=False)
    t_warm = render_seconds(scene, cam, tile)  # the warm-up fills the cache: the timed runs hit
    if not cr.warm_cache_hit(scene, cam, tile=tile):
        raise RuntimeError("the warm render did not fill the schedule cache")
    peak = kp.time_part("fma_peak", kp.FILL_TILE, 64, dev).rate
    chain = chain_rate()
    sweep_ops = s["work"] * scene.num_slots * kp.OPS_PER_SPHERE_TEST
    roofline_s = sweep_ops / kp.PEAK_F32_OPS
    roofline_measured_s = sweep_ops / peak
    for name, key, t in (("cold", "cold", t_cold), ("pixel-order", "pixel", t_pixel),
                         ("warm", "warm", t_warm)):
        log(f"render {name}: {t:.5f}s ({rays / t / 1e6:.1f} Mrays/s) warp_iters={s[key]:.0f} "
            f"occupancy {100 * s[f'occupancy_{key}']:.1f}% [{smi}]")
    log(f"roofline: lane_iters={s['work']:.0f} warp_ideal={s['ideal']:.0f} "
        f"sweep_ops={sweep_ops / 1e12:.3f}T fma_peak={peak / 1e12:.2f} TFLOP/s "
        f"chain={chain / 1e12:.2f} TFLOP/s (one dependent chain per element) "
        f"t_sweep_roofline={roofline_s * 1e3:.3f} ms at 67 TFLOP/s, {roofline_measured_s * 1e3:.3f} ms at "
        f"the measured peak ({100 * roofline_s / t_cold:.1f}% of the cold render, "
        f"{100 * roofline_s / t_warm:.1f}% of the warm) [{smi}]")
    result = {
        "tile": tile, "budget": budget, "n_passes": n_passes,
        "render_s": t_cold, "mrays": rays / t_cold / 1e6,
        "lane_iters": s["work"], "warp_iters": s["cold"],
        "peak_tflops": peak / 1e12, "chain_tflops": chain / 1e12, "roofline_s": roofline_s,
        "roofline_measured_peak_s": roofline_measured_s,
        "warp_ideal": s["ideal"], "warp_iters_pixel": s["pixel"], "warp_iters_warm": s["warm"],
        "occupancy_cold": s["occupancy_cold"], "occupancy_pixel": s["occupancy_pixel"],
        "occupancy_warm": s["occupancy_warm"],
        "render_s_pixel": t_pixel, "render_s_warm": t_warm,
        "roofline_share_cold": roofline_s / t_cold, "roofline_share_warm": roofline_s / t_warm,
        "passes": s["passes"], "card": smi,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
