"""The keyed train step's gradient against the exact sum of its own events,
at the bench preset: the kernels', the autograd oracle's and the plain
float32 reverse's.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.keyed_grad_exact [--chunks N,...] [--width W] [--device cpu]

The step is `parallel.dist.render_grads` on threefry key 0 (cover scene,
1200x800, 10 spp, depth 50, zero target). Its paths as the keyed forward
records them (`keyed_step_paths`: the recording forward's image and
records, the loss's per-sample cotangent) are walked by the reverse
kernel and by the plain per-path reverse
(`cuda_threefry.reverse_paths_plain`, torch.autograd of the plain keyed
bounce), and each walk's events are
summed in float64 and taken through `pack_scene`'s chain rule as
`shard_error.exact_grads` takes its sum (`keyed_exact_grads`: the
kernels' own events, the yardstick of chip_smoke.py's phase 16c). Per
scene field it prints the relative L2 from the exact sum of the kernels'
events of the kernels' gradient, of the plain reverse's events summed
exactly (the walks' per-event difference alone), and of the autograd
oracle's gradient (`render_grads_autograd`) at each chunk size of
`--chunks` (pixels a chunk of its backward's re-render; default the whole
image), with the oracle's seconds and peak memory; and the ratio of the
exact sum of the events' magnitudes to the field's total (how far its
terms cancel). `--width` and `--device cpu` (where the plain reverse
stands in for the kernel) shrink it for a rehearsal.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_threefry as ct
from ray_tracing_in_one_weekend_tpu_torch.ops import render as rr
from ray_tracing_in_one_weekend_tpu_torch.ops.threefry import as_key
from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi, rel_l2
from ray_tracing_in_one_weekend_tpu_torch.probes.grad_exact import _sum_events
from ray_tracing_in_one_weekend_tpu_torch.probes.shard_error import params_f64
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)


def keyed_step_paths(scene, cam, target, base_key=0):
    """The keyed step's paths as its forward records them, on the loss's
    image cotangent -> (image [n, 3], p_mat, cam_vec, rec, slots, n_events,
    g): the recording of `cuda_threefry.record_keyed` (the kernel on the
    card, at its exact count; the plain version on the CPU), where its
    events go (`build.path_slots`: slots and their count), and g [3, n]
    each pixel's cotangent of one sample (the image's / spp, as
    `_DiffRenderKeyed` takes it)."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    n, spp, dev = cam.num_pixels, cam.samples_per_pixel, scene.device
    pix = torch.arange(n, device=dev)
    img, _, rec = ct.record_keyed(scene, cam, pix, base_key)
    rec = build.complete_recording(rec, int(rec.total))
    leaf = img.detach().requires_grad_()
    with torch.enable_grad():
        loss = torch.mean((leaf.reshape(cam.image_height, cam.image_width, 3) - target) ** 2)
        (grad_img,) = torch.autograd.grad(loss, leaf)
    g = (grad_img.T / spp).contiguous()
    slots, n_events = build.path_slots(rec.pix, rec.path_count, spp, 0, n)
    return img, rec.table.T, rec.cam_vec, rec, slots, int(n_events), g


def keyed_events(p_mat, cam_vec, rec, slots, n_events, g):
    """The reverse kernel's events (the card), the plain per-path reverse's
    on the CPU."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    if g.device.type != "cuda":
        return ct.reverse_paths_plain(p_mat, cam_vec, rec, slots, n_events, g)
    return build.threefry_reverse(rec, slots, n_events, g, int(rec.total))


def keyed_exact_grads(scene, cam, target, base_key=0) -> dict:
    """The keyed step's gradient with its events summed in float64 ->
    float64 tensors by field."""
    _, p_mat, cam_vec, rec, slots, n_events, g = keyed_step_paths(scene, cam, target, base_key)
    return params_f64(scene, _sum_events(keyed_events(p_mat, cam_vec, rec, slots, n_events, g), p_mat.shape[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default=None, help="the oracle's chunk sizes, comma-separated (default: the image)")
    ap.add_argument("--width", type=int, default=None, help="the image width (default: the preset's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("keyed_grad_exact: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    config = PRESETS["bench"]
    if args.width:
        config = dataclasses.replace(config, image_width=args.width)
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    chunks = [int(c) for c in args.chunks.split(",")] if args.chunks else [cam.num_pixels]
    _, kernels = pdist.render_grads(cg.scene_params(scene), scene, cam, target, 0)
    t0 = time.perf_counter()
    _, p_mat, cam_vec, rec, slots, n_events, g = keyed_step_paths(scene, cam, target)
    n = p_mat.shape[1]
    ek = keyed_events(p_mat, cam_vec, rec, slots, n_events, g)
    ep = ct.reverse_paths_plain(p_mat, cam_vec, rec, slots, n_events, g)
    walks_s = time.perf_counter() - t0
    exact, plain = params_f64(scene, _sum_events(ek, n)), params_f64(scene, _sum_events(ep, n))
    mags = {k: float(v.norm()) for k, v in params_f64(scene, _sum_events(ek, n, magnitudes=True)).items()}
    oracles = {}
    for chunk in chunks:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = pdist.render_grads_autograd(cg.scene_params(scene), scene, cam, target, 0, chunk_size=chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
        oracles[chunk] = (grads, time.perf_counter() - t0, peak)
    print(f"keyed_grad_exact: {cam.image_width}x{cam.image_height}, spp {cam.samples_per_pixel}, depth "
          f"{cam.max_depth}, {n_events} events, the recording and both reverse walks {walks_s:.1f} s on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          + (f" [{nvidia_smi()}]" if dev.type == "cuda" else ""))
    for chunk, (_, seconds, peak) in oracles.items():
        print(f"  autograd oracle at chunk {chunk}: {seconds:.2f} s, peak memory {peak:.3f} GB")
    for k in cg.DIFF_FIELDS:
        line = (f"  {k}: rel L2 from the exact sum of the kernels' events: kernels {rel_l2(kernels[k], exact[k]):.3e}, "
                f"plain reverse's events summed exactly {rel_l2(plain[k], exact[k]):.3e}, ")
        line += ", ".join(f"autograd at chunk {c} {rel_l2(o[0][k], exact[k]):.3e}" for c, o in oracles.items())
        line += (f"; kernels vs autograd " + ", ".join(f"{rel_l2(kernels[k], o[0][k]):.3e}" for o in oracles.values())
                 + f"; terms' magnitude {mags[k] / float(exact[k].norm()):.3f}x the total")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
