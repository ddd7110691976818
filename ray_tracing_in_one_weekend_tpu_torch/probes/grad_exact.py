"""The train step's gradient against a float64 reverse walk of its own
paths, at the bench preset, and where the ior field's float32 gradients
part.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.grad_exact [--width W] [--device cpu]

The reference: the step's paths as the backward replays them (the
forward's decisions and float32 points, `shard_error.step_paths`) walked in
reverse in float64 by the plain reverse
(`cuda_grad._reverse_records_plain(..., dtype=torch.float64)`), the events
summed in float64 and taken through `pack_scene`'s chain rule as
`shard_error.exact_grads` takes its sum. It shares no arithmetic with the
reverse kernel's float32 adjoint nor with the autograd oracle's float32
tape. Per scene field it prints the relative L2 from the reference of the
kernels' gradient (`render_grads_cuda`), of the autograd oracle's
(`parallel.dist.render_grads_pcg`) and of the plain float32 reverse on the
same records, the kernels' from the oracle's, the ratio of the sum of the
reference's per-event magnitudes to its total (how far the field's terms
cancel), and the kernels' and the oracle's relative L2 from the exact
float64 sum of the kernels' own events (`shard_error.exact_grads`, the
yardstick of chip_smoke.py's phases 11b and 14c).

Then, for the ior events of the sphere with the largest ior gradient, the
gap between the kernel's events and the plain float32 reverse's: the share
of it that its TOP events carry, their distance from their path's end,
the largest event's magnitude over the sphere's total, and each walk's
median per-event relative error from the float64 walk. Bench preset: cover
scene, 1200x800, 10 spp, depth 50, zero target; `--width` and
`--device cpu` (where the plain reverse stands in for the kernel) shrink
it for a rehearsal.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi, rel_l2
from ray_tracing_in_one_weekend_tpu_torch.probes.shard_error import exact_grads, params_f64, step_paths
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

TOP = 20


def _winners(events) -> torch.Tensor:
    """Word 0 of events [E, 16]: int32 bits in float32 events, a value in
    float64 ones."""
    if events.dtype == torch.float32:
        return events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    return events[:, 0].to(torch.int64)


def _sum_events(events, n_spheres, magnitudes=False) -> torch.Tensor:
    """Events [E, 16] summed per sphere in float64 -> [16, N]; with
    `magnitudes`, of each event's absolute values."""
    idx = _winners(events)
    keep = (idx >= 0) & (idx < n_spheres)
    vals = events[keep, 1:14].double()
    out = torch.zeros(16, n_spheres, dtype=torch.float64, device=events.device)
    rows = list(cg._EVENT_ROWS)
    out[rows] = out[rows].index_add(1, idx[keep], vals.abs().T if magnitudes else vals.T)
    return out


def ior_gap(records, e64, e32, ek, sphere: int) -> str:
    """Where the kernel's and the plain float32 reverse's ior events of
    `sphere` part, against the float64 walk's."""
    col = 1 + cg._EVENT_ROWS.index(cr._IOR)
    mine = _winners(ek) == sphere
    a64, a32, ak = e64[mine, col], e32[mine, col].double(), ek[mine, col].double()
    total = float(a64.sum())
    gap = a32 - ak
    top = gap.abs().topk(min(TOP, gap.numel()))
    _, _, back = cg._path_positions(records)
    back = back[mine][top.indices]
    nz = a64 != 0
    med32 = float(((a32 - a64)[nz] / a64[nz]).abs().median())
    medk = float(((ak - a64)[nz] / a64[nz]).abs().median())
    where = "no gap"
    if bool(gap.any()):
        where = (f"{float(gap[top.indices].sum() / gap.sum()):.1%} of that in the top {top.indices.numel()} "
                 f"events ({float(top.values.sum() / gap.abs().sum()):.1%} of its magnitude), "
                 f"{int(back.min())}-{int(back.max())} bounces from their path's end")
    return (f"sphere {sphere}'s {int(mine.sum())} ior events, total {total:.6e}: plain float32 minus "
            f"kernel {float(gap.sum()) / abs(total):.3e} of it, {where}; the largest event "
            f"{float(a64.abs().max()) / abs(total):.2f}x the total; median per-event relative error from "
            f"the float64 walk: plain float32 {med32:.2e}, kernel {medk:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=None, help="the image width (default: the preset's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("grad_exact: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    config = PRESETS["bench"]
    if args.width:
        config = dataclasses.replace(config, image_width=args.width)
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    _, kernels = cg.render_grads_cuda(cg.scene_params(scene), scene, cam, target)
    exact = exact_grads(scene, cam, target)
    t0 = time.perf_counter()
    p_mat, cam_vec, replay, g = step_paths(scene, cam, target)
    n = p_mat.shape[1]
    records = replay.records.clone()
    e64 = cg._reverse_records_plain(p_mat, cam_vec, replay, g, dtype=torch.float64)
    e32 = cg._reverse_records_plain(p_mat, cam_vec, replay, g)
    walks_s = time.perf_counter() - t0
    ek = (build.grad_reverse(p_mat.T.contiguous(), cam_vec, replay, g, cg.DEFAULT_BWD_TILE)
          if dev.type == "cuda" else e32)
    ref, plain = params_f64(scene, _sum_events(e64, n)), params_f64(scene, _sum_events(e32, n))
    mags = {k: float(v.norm()) for k, v in params_f64(scene, _sum_events(e64, n, magnitudes=True)).items()}
    _, oracle = pdist.render_grads_pcg(cg.scene_params(scene), scene, cam, target)
    print(f"grad_exact: {cam.image_width}x{cam.image_height}, spp {cam.samples_per_pixel}, depth "
          f"{cam.max_depth}, replay and both plain reverse walks {walks_s:.1f} s on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          + (f" [{nvidia_smi()}]" if dev.type == "cuda" else ""))
    for k in cg.DIFF_FIELDS:
        print(f"  {k}: rel L2 from the float64 reference: kernels {rel_l2(kernels[k], ref[k]):.3e}, "
              f"autograd {rel_l2(oracle[k], ref[k]):.3e}, plain float32 {rel_l2(plain[k], ref[k]):.3e}; "
              f"kernels vs autograd {rel_l2(kernels[k], oracle[k]):.3e}; terms' magnitude "
              f"{mags[k] / float(ref[k].norm()):.3f}x the total; from the exact sum of the kernels' events: "
              f"kernels {rel_l2(kernels[k], exact[k]):.3e}, autograd {rel_l2(oracle[k], exact[k]):.3e}")
    print("  " + ior_gap(records, e64, e32, ek, int(ref["ior"].abs().argmax())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
