"""Entry points: a one-device render check and the multi-rank dry run.

The torch-only counterpart of the repo's `__graft_entry__.py`:

* `entry()` returns a forward render on the flagship workload (the
  488-sphere cover scene) at small example shapes, and its arguments;
* `dryrun_multichip(n)` launches n local ranks (`parallel/worker.py`) on
  an ('pixels', 'samples') mesh and runs, on each, a sharded render of a
  target and ONE sharded differentiable training step through the
  kernels: the sharded forward, the backward kernels on each rank's slab,
  the cross-rank sum of the [16, N] cotangent, the SGD update.

Both run on the card unless the caller passes `device="cpu"`. Ranks that
share one GPU talk over gloo (NCCL needs one GPU a rank).

    python -m ray_tracing_in_one_weekend_tpu_torch.entry [--ranks N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile

import torch


def _small_camera(spp=2, width=64, device="cuda"):
    from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera

    return make_camera(image_width=width, aspect_ratio=2.0, samples_per_pixel=spp, max_depth=8,
                       device=device)


def entry(device="cuda"):
    """(fn, example_args): fn(scene, seed) renders the cover scene at 64x32,
    2 spp, through the kernel on the card (the plain version on a CPU
    scene)."""
    from ray_tracing_in_one_weekend_tpu_torch.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda

    scene = cover_scene(0, device=device)
    cam = _small_camera(spp=2, width=64, device=device)

    def fn(scene, seed):
        return render_cuda(scene, cam, seed=seed)

    return fn, (scene, 0)


def mesh_shape_for(n_ranks: int) -> tuple[int, int]:
    """Two mesh axes whenever the rank count allows: (n/2, 2) for an even
    n >= 4, else (n, 1)."""
    return (n_ranks // 2, 2) if n_ranks % 2 == 0 and n_ranks >= 4 else (n_ranks, 1)


def dryrun_rank(mesh, device) -> dict:
    """One rank's part of the dry run -> its loss and the shapes it saw.
    Raises if a value is not finite."""
    from ray_tracing_in_one_weekend_tpu_torch.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_grad import train_step_cuda
    from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda_distributed
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist

    scene = cover_scene(0, device=device)
    cam = _small_camera(spp=2 * mesh.samples, width=32, device=device)
    target = render_cuda_distributed(scene, cam, seed=0, mesh=mesh)
    if tuple(target.shape) != (cam.image_height, cam.image_width, 3):
        raise RuntimeError(f"sharded target of shape {tuple(target.shape)}")
    if not bool(torch.isfinite(target).all()):
        raise RuntimeError("non-finite sharded target")
    img = render_cuda_distributed(scene, cam, seed=0, mesh=mesh, tile=128, spp=mesh.samples,
                                  max_depth=4)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("non-finite sharded render")
    loss, new_params = train_step_cuda(dist.scene_params(scene), scene, cam, target, mesh=mesh,
                                       spp=mesh.samples, max_depth=4, tile=128, bwd_tile=128,
                                       lr=1e-2)
    if not math.isfinite(float(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")
    for name, p in new_params.items():
        if not bool(torch.isfinite(p).all()):
            raise RuntimeError(f"non-finite parameter {name}")
    return {"loss": float(loss), "image_shape": tuple(target.shape)}


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 300.0) -> dict:
    """Run one sharded training step on an n-rank mesh of local processes
    -> {"mesh": (P, S), "losses": per rank}. Raises if a rank fails, times
    out, returns a non-finite value, or the ranks' losses differ."""
    from ray_tracing_in_one_weekend_tpu_torch.parallel import worker

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip on the card needs a CUDA GPU (pass device='cpu' for "
                           "the plain versions)")
    shape = mesh_shape_for(n_devices)
    worker.SCRATCH.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="dryrun_", dir=worker.SCRATCH) as tmp:
        ranks = worker.launch([{"job": "dryrun", "mesh": shape}], n_devices, tmp,
                              device=device.type, timeout=timeout)
    losses = [r[0]["loss"] for r in ranks]
    if len(set(losses)) != 1:
        raise RuntimeError(f"the ranks' losses differ: {losses}")
    return {"mesh": shape, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the GPUs, at least 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry ok: {tuple(out.shape)} {out.dtype}")
    n = args.ranks or max(1, torch.cuda.device_count())
    res = dryrun_multichip(n, device=args.device)
    print(f"dryrun_multichip({n}) ok: mesh {res['mesh']}, loss {res['losses'][0]:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
