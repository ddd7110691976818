"""Inverse rendering: recover damaged sphere albedos from a target image.

    python -m ray_tracing_in_one_weekend_tpu_torch.examples.inverse_render [--steps 40]

The port of `examples/inverse_render.py`, with its defaults: the
three-sphere scene padded to 128 slots, 64 pixels wide, 4 spp, depth 8.
It renders the target, damages sphere 1's albedo to (0.6, 0.6, 0.6) and
sphere 3's to (0.3, 0.3, 0.8), and runs albedo-only SGD (lr 30, clipped
to [0, 1]) on the mean squared pixel error.

`--backend jnp` (the default, as in the JAX example) renders on the JAX
package's threefry keys from key 0: the target and the recovered image by
`parallel.dist.render_image_distributed` (chunks of 2048 pixels), every
step's gradient by `parallel.dist.render_grads` (the keyed gradient: on
the card the forward kernel and the keyed backward kernels,
`csrc/threefry_grad_kernel.cu`; on the CPU torch.autograd through the
plain render). `--backend pallas` is the JAX example's kernel route on the
port's PCG streams: the target and the recovered image by `render_cuda`,
each step by the PCG backward kernels (`ops/cuda_grad.py`) with the
warm-start carry between steps.

`--grad kernel` (the default) takes that route's gradient; `--grad
autograd` its autodiff oracle, torch.autograd through the plain render,
which launches no kernel: `parallel.dist.render_grads_autograd` on the
keys, `parallel.dist.render_grads_pcg` on the PCG streams. It logs the
loss to stderr, writes the target and recovered images as PPM to
`--outdir`, and exits 0 only if sphere 1's albedo L1 error fell below
half its start.

`--device cuda` (the default) needs a GPU and never moves to the CPU on
its own; `--device cpu` runs the plain PyTorch versions.

`--mesh P[,S]` shards the target render and every step over a mesh of
ranks (`parallel/dist.py`), one process a rank, as the root example's
`--mesh` does:

    torchrun --nproc-per-node 2 -m ray_tracing_in_one_weekend_tpu_torch.examples.inverse_render --mesh 1,2

Every rank takes the same steps; rank 0 alone logs and writes the images.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

from ray_tracing_in_one_weekend_tpu_torch.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu_torch.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import render_cuda, render_cuda_distributed
from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist
from ray_tracing_in_one_weekend_tpu_torch.utils import ppm

_DEFAULT_OUTDIR = Path(__file__).resolve().parents[2] / "build" / "inverse_render"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=30.0)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=("jnp", "pallas"), default="jnp",
                    help="jnp (default): threefry keys, render_image_distributed and dist.render_grads; "
                         "pallas: the PCG streams, render_cuda and the PCG backward kernels")
    ap.add_argument("--grad", choices=("kernel", "autograd"), default="kernel",
                    help="the steps' gradient: the backend's kernels (default) or torch.autograd "
                         "through the plain render")
    ap.add_argument("--mesh", default=None, metavar="P[,S]",
                    help="rank mesh: pixel shards, optional sample shards (under torchrun)")
    ap.add_argument("--outdir", default=str(_DEFAULT_OUTDIR))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("inverse_render: --device cuda needs a CUDA GPU (use --device cpu for the plain "
              "version)", file=sys.stderr)
        return 2
    mesh = None
    if args.mesh is not None:
        from ray_tracing_in_one_weekend_tpu_torch.parallel import dist
        from ray_tracing_in_one_weekend_tpu_torch.utils.cli import parse_mesh

        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_distributed()
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        mesh = dist.make_mesh(parse_mesh(args.mesh))
        mesh.build_kernels(device)
    rank0 = mesh is None or mesh.rank == 0

    def log(*a):
        if rank0:
            print(*a, file=sys.stderr)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    keyed = args.backend == "jnp"

    def render(scene):
        if keyed:
            return pdist.render_image_distributed(scene, cam, 0, mesh, chunk_size=2048)
        if mesh is not None:
            return render_cuda_distributed(scene, cam, seed=0, mesh=mesh)
        return render_cuda(scene, cam, seed=0)

    scene = scene_lib.three_sphere_scene(pad_to=128, device=device)
    cam = make_camera(
        image_width=args.width, aspect_ratio=2.0, samples_per_pixel=args.spp, max_depth=8,
        vfov_degrees=90.0, lookfrom=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0, focus_dist=1.5, device=device,
    )
    target = render(scene)

    params = cg.scene_params(scene)
    true_albedo = params["albedo"]
    damaged = true_albedo.clone()
    damaged[1] = torch.tensor([0.6, 0.6, 0.6], device=device)
    damaged[3] = torch.tensor([0.3, 0.3, 0.8], device=device)
    params["albedo"] = damaged
    before_err = float((params["albedo"][1] - true_albedo[1]).abs().sum())

    work = None  # the warm-start carry of the PCG kernels: the previous step's cost map
    for step in range(args.steps):
        if keyed:
            grads_fn = pdist.render_grads_autograd if args.grad == "autograd" else pdist.render_grads
            loss, grads = grads_fn(params, scene, cam, target, 0, mesh, chunk_size=2048)
        elif args.grad == "autograd":
            loss, grads = pdist.render_grads_pcg(params, scene, cam, target, seed=0, mesh=mesh)
        else:
            (loss, work), grads = cg.render_grads_cuda(
                params, scene, cam, target, mesh=mesh, seed=0, work_hint=work, return_work=True
            )
        # albedo-only SGD: the geometry is already right in this demo
        params["albedo"] = torch.clamp(params["albedo"] - args.lr * grads["albedo"], 0.0, 1.0)
        if step % 5 == 0 or step == args.steps - 1:
            log(f"step {step:3d}  loss {float(loss):.6f}")

    after_err = float((params["albedo"][1] - true_albedo[1]).abs().sum())
    log(f"albedo L1 error sphere 1: {before_err:.3f} -> {after_err:.3f}")

    final = render(cg.scene_with_params(scene, params))
    if rank0:
        for name, img in (("target", target), ("recovered", final)):
            ppm.write_ppm(to_uint8(img).cpu().numpy(), str(outdir / f"inverse_{name}.ppm"))
    log(f"wrote {outdir}/inverse_{{target,recovered}}.ppm")
    return 0 if after_err < before_err * 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
