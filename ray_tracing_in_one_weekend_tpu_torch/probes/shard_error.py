"""The sharded train step's gradient error, against one device and against
the exact sum of the backward's events, at the bench preset.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.shard_error [--meshes 2x1,1x2,2x2,4x1]

One device: `render_grads_cuda` (cover scene, 1200x800, 10 spp, depth 50,
zero target). The exact gradient: the same step's events (the backward
kernels on the loss's image cotangent), summed in float64 and taken
through `pack_scene`'s chain rule with the float64 cotangent split into two
float32 halves. Each mesh runs in local ranks (`parallel/worker.py`; ranks
that share the card use gloo). Per mesh and scene field it prints the
largest elementwise |a - b| / (atol + rtol |b|) at rtol 2e-5, atol 1e-6
(the JAX package's gradient tolerances) of the sharded gradient against
one device's and against the exact one, and one device's own against the
exact one, with the worst element. `--width` and `--device cpu` (the
plain versions) shrink it for a rehearsal.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    PRESETS,
    make_camera_from_config,
    make_scene_from_config,
)

RTOL, ATOL = 2e-5, 1e-6


def step_paths(scene, cam, target):
    """The step's paths as the backward replays them, on the loss's image
    cotangent -> (p_mat, cam_vec, replay, g): `build.grad_replay` on the
    card, `cuda_grad._replay_records_plain` on the CPU."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    n, spp, depth = cam.num_pixels, cam.samples_per_pixel, cam.max_depth
    img, work = cg.render_cuda_diff(scene, cam, return_work=True)
    leaf = img.detach().requires_grad_()
    with torch.enable_grad():
        loss = torch.mean((leaf - target) ** 2)
        (grad_img,) = torch.autograd.grad(loss, leaf)
    work = work.reshape(-1)
    pix, g = cg._bwd_lanes(work, grad_img.reshape(n, 3).T, spp, cg.DEFAULT_BWD_TILE)
    p_mat, cam_vec = cr.pack_scene(scene), cr.pack_camera(cam).to(scene.device)
    scalars = (0, 0, 0, n)
    if scene.device.type == "cuda":
        replay = build.grad_replay(p_mat.T.contiguous(), cam_vec, scalars, pix, work, cg.DEFAULT_BWD_TILE,
                                   spp, depth)
    else:
        replay = cg._replay_records_plain(p_mat, cam_vec, scalars, pix, spp, depth)
    return p_mat, cam_vec, replay, g


def params_f64(scene, p_bar) -> dict:
    """A float64 cotangent [16, N] of the packed scene -> float64 gradients
    by field: `pack_scene`'s chain rule on the cotangent split into two
    float32 halves."""
    hi = p_bar.float()
    lo = (p_bar - hi.double()).float()
    parts = [cg.params_vjp(scene, half) for half in (hi, lo)]
    return {k: parts[0][k].double() + parts[1][k].double() for k in parts[0]}


def exact_grads(scene, cam, target) -> dict:
    """The step's gradient with its events summed in float64 -> float64
    tensors by field."""
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    p_mat, cam_vec, replay, g = step_paths(scene, cam, target)
    if scene.device.type == "cuda":
        events = build.grad_reverse(p_mat.T.contiguous(), cam_vec, replay, g, cg.DEFAULT_BWD_TILE)
    else:
        events = cg._reverse_records_plain(p_mat, cam_vec, replay, g)
    idx = events[:, 0].contiguous().view(torch.int32).to(torch.int64)
    keep = (idx >= 0) & (idx < p_mat.shape[1])
    exact = torch.zeros(16, p_mat.shape[1], dtype=torch.float64, device=p_mat.device)
    rows = list(cg._EVENT_ROWS)
    exact[rows] = exact[rows].index_add(1, idx[keep], events[keep, 1:14].double().T)
    return params_f64(scene, exact)


def excess(a, b):
    """(largest |a - b| / (ATOL + RTOL |b|), the index of that element)."""
    a, b = a.double().cpu(), b.double().cpu()
    ratio = ((a - b).abs() / (ATOL + RTOL * b.abs())).reshape(-1)
    i = int(ratio.argmax())
    return float(ratio[i]), i


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="2x1,1x2,2x2,4x1")
    ap.add_argument("--width", type=int, default=None, help="the image width (default: the preset's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("shard_error: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker
    from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi

    config = PRESETS["bench"]
    if args.width:
        config = dataclasses.replace(config, image_width=args.width)
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    _, one = cg.render_grads_cuda(cg.scene_params(scene), scene, cam, target)
    exact = exact_grads(scene, cam, target)
    print(f"shard_error: {cam.image_width}x{cam.image_height}, spp {cam.samples_per_pixel}, depth "
          f"{cam.max_depth} on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          + (f" [{nvidia_smi()}]" if dev.type == "cuda" else ""))
    for k in cg.DIFF_FIELDS:
        e, i = excess(one[k], exact[k])
        print(f"  one device vs exact, {k}: {e:.3f} of the gate at element {i} "
              f"(exact {float(exact[k].reshape(-1)[i]):.6e}, one {float(one[k].reshape(-1)[i]):.6e})")
    meshes = [tuple(int(v) for v in m.split("x")) for m in args.meshes.split(",")]
    spec = {"scene": worker.scene_spec(scene), "camera": worker.camera_spec(cam)}
    for n_ranks in sorted({p * s for p, s in meshes}):
        group = [m for m in meshes if m[0] * m[1] == n_ranks]
        worker.SCRATCH.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="shard_error_", dir=worker.SCRATCH) as tmp:
            ranks = worker.launch([{"job": "step", "mesh": m, **spec} for m in group], n_ranks, tmp,
                                  device=dev.type, timeout=600.0)
        for j, m in enumerate(group):
            grads = ranks[0][j]["grads"]
            for k in cg.DIFF_FIELDS:
                e1, i1 = excess(grads[k], one[k])
                e2, i2 = excess(grads[k], exact[k])
                print(f"  {m[0]}x{m[1]} {k}: vs one device {e1:.3f} of the gate at element {i1} "
                      f"(sharded {float(grads[k].reshape(-1)[i1]):.6e}, one "
                      f"{float(one[k].reshape(-1)[i1]):.6e}); vs exact {e2:.3f} at element {i2}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
