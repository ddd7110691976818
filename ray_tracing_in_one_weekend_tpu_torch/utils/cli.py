"""Command-line renderer: PPM to stdout, logs to stderr.

The PyTorch counterpart of ray_tracing_in_one_weekend_tpu/utils/cli.py,
with the same flag names and meanings (the reference's whole CLI contract
is `./main > out.ppm`, reference: script/windows/rt-utility.psm1:33-47):

    python -m ray_tracing_in_one_weekend_tpu_torch --preset bench > out.ppm
    python -m ray_tracing_in_one_weekend_tpu_torch --backend torch --width 200 > out.ppm
    python -m ray_tracing_in_one_weekend_tpu_torch --preset gpu \
        --checkpoint gpu.npz --png gpu.png > gpu.ppm
    torchrun --nproc-per-node 2 -m ray_tracing_in_one_weekend_tpu_torch \
        --preset bench --mesh 2 > out.ppm

Backends: `cuda` (the default) runs the hand-written kernel on the first
GPU, and raises when there is none; `torch` runs the plain PyTorch
version on the CPU, and only when asked for; `jnp` is the JAX package's
jnp backend on threefry keys: `threefry_render_kernel` on the GPU, or with
`--platform cpu` its plain version on the CPU, `--chunk` pixels at a time
(no pixel changes with the chunk). `--platform {auto,cpu,gpu}` is the JAX
flag with the card in the TPU's place: `cpu` runs `cuda` as `torch` and
`jnp` on the CPU; `auto` and `gpu` need a GPU for `cuda` and `jnp`.

    python -m ray_tracing_in_one_weekend_tpu_torch --backend jnp --preset cpu --png jnp.png > jnp.ppm
    python -m ray_tracing_in_one_weekend_tpu_torch --backend jnp --platform cpu --width 120 > jnp.ppm

Two paths, as in the JAX CLI:

* in one piece (spp < 64, `--no-progress` or `--profile`): the render is
  timed the way the reference times it, wall clock around the render only
  (reference: src/gpu/main.cu:128-139), after one warm-up render, with
  `torch.cuda.synchronize()` as the barrier on the GPU. The warm-up fills
  the warm-start cache, so the timed render runs the warm schedule (one
  pass over cost-sorted lanes) unless `--cold` is given;
* in sample batches (spp >= 64, or `--checkpoint`): batches of
  `--spp-batch` samples (default spp // 10), each on the next global
  sample window, with one `samples k/N` line a batch on stderr and one
  `torch.cuda.synchronize()` a batch as its barrier; `--checkpoint`
  saves the state after every batch and resumes from it, `--retries`
  renders a failed batch again. There is no warm-up render: the first
  batch builds the kernels, and the total says "incl compile".

Mrays/s = width * height * spp / render seconds / 1e6, over this
session's samples. In one piece the render seconds span the render that
made the image, to its synchronize; the finiteness check that `--retries`
acts on, and failed attempts, fall outside them.

Sharding (`--mesh P[,S]`, parallel/dist.py): under torchrun, or with
`--multihost` and an explicit `--coordinator`, each process is one rank of
the ('pixels', 'samples') mesh and renders its pixel slab and sample
window; every rank gets the whole image. Rank 0 builds the kernels before
the others load them, and rank 0 alone logs and writes stdout, the PPM,
the PNG and the checkpoint. A timed span ends when every rank has
synchronized its device (a barrier), and Mrays/s counts the whole image.
The batched path rounds its batch to a multiple of S.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from ray_tracing_in_one_weekend_tpu_torch.ops.cuda_render import (
    DEFAULT_TILE,
    render_cuda,
    render_cuda_distributed,
    warm_cache_hit,
)
from ray_tracing_in_one_weekend_tpu_torch.ops.image import to_uint8
from ray_tracing_in_one_weekend_tpu_torch.ops.render import render_image
from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_in_one_weekend_tpu_torch.utils import ppm
from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
    BACKENDS,
    PLATFORMS,
    PRESETS,
    RenderConfig,
    make_camera_from_config,
    make_scene_from_config,
)
from ray_tracing_in_one_weekend_tpu_torch.utils.png import write_png
from ray_tracing_in_one_weekend_tpu_torch.utils.resilient import (
    accumulate_resilient,
    validate_state,
    with_retries,
)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p =argparse.ArgumentParser(
        prog="ray_tracing_in_one_weekend_tpu_torch",
        description="Path tracer on PyTorch + a hand-written CUDA kernel (PPM to stdout).",
    )
    d = RenderConfig()
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="start from a reference workload preset")
    p.add_argument("--width", type=int, default=None, help=f"image width (default {d.image_width})")
    p.add_argument("--aspect", type=float, default=None, help="aspect ratio w/h")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=None, help="bounce limit")
    p.add_argument("--vfov", type=float, default=None, help="vertical fov, degrees")
    p.add_argument("--lookfrom", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--lookat", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--vup", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--defocus-angle", type=float, default=None,
                   help="defocus cone angle, degrees (0 = pinhole)")
    p.add_argument("--aperture", type=float, default=None,
                   help="CPU-tree lens aperture (overrides --defocus-angle)")
    p.add_argument("--focus-dist", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scene", choices=("cover", "three", "single"), default=None)
    p.add_argument("--tile", type=int, default=DEFAULT_TILE,
                   help=f"lanes per CUDA block, a multiple of 128 (default {DEFAULT_TILE})")
    p.add_argument("--chunk", type=int, default=None,
                   help=f"pixels per chunk of the jnp backend's plain path (default {d.chunk_pixels}; "
                        "no pixel changes with it)")
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="cuda (default): the kernel on the GPU; torch: the plain version on the CPU; "
                        "jnp: the JAX jnp backend on threefry keys (its kernel on the GPU)")
    p.add_argument("--platform", choices=PLATFORMS, default="auto",
                   help="cpu: cuda runs as torch, jnp on the CPU; auto/gpu: cuda and jnp need a GPU")
    p.add_argument("--mesh", default=None, metavar="P[,S]",
                   help="rank mesh: pixel shards, optional sample shards (one process a rank: "
                        "run under torchrun, or with --multihost)")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group (implied under torchrun)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address for --multihost (default: torchrun's environment)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --multihost with --coordinator")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id for --multihost with --coordinator")
    p.add_argument("--cold", action="store_true",
                   help="disable warm-start scheduling: every render runs the cold multi-pass "
                        "compaction schedule instead of reusing the cached cost-sorted lane "
                        "permutation (bit-identical image either way)")
    p.add_argument("--out", default="-", help="output PPM path ('-' = stdout)")
    p.add_argument("--png", default=None, help="also write a PNG here")
    p.add_argument("--no-output", action="store_true", help="render + report timing only")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the timed render with torch.profiler into DIR/trace.json "
                        "(Chrome trace format; renders in one piece)")
    p.add_argument("--checkpoint", default=None, metavar="FILE.npz",
                   help="progressive rendering: accumulate into FILE.npz, resuming if it exists; "
                        "the final image equals a monolithic run (same sample streams; within "
                        "float rounding)")
    p.add_argument("--spp-batch", type=int, default=None,
                   help="samples per accumulation batch (progress/--checkpoint; default spp // 10)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="elastic recovery: re-render a failed/corrupt sample batch up to N times "
                        "before failing stop (utils/resilient.py)")
    p.add_argument("--no-progress", action="store_true",
                   help="render monolithically even at high spp (suppresses the per-batch "
                        "progress lines)")
    return p


def config_from_args(args) -> RenderConfig:
    config = PRESETS[args.preset] if args.preset else RenderConfig()
    mapping = {
        "width": "image_width",
        "aspect": "aspect_ratio",
        "spp": "samples_per_pixel",
        "max_depth": "max_depth",
        "vfov": "vfov_degrees",
        "lookfrom": "lookfrom",
        "lookat": "lookat",
        "vup": "vup",
        "defocus_angle": "defocus_angle_degrees",
        "aperture": "aperture",
        "focus_dist": "focus_dist",
        "seed": "seed",
        "scene": "scene",
        "chunk": "chunk_pixels",
        "backend": "backend",
    }
    updates = {}
    for arg_name, field in mapping.items():
        v = getattr(args, arg_name)
        if v is not None:
            updates[field] = tuple(v) if isinstance(v, list) else v
    if args.mesh is not None:
        updates["mesh_shape"] = parse_mesh(args.mesh)
    return dataclasses.replace(config, **updates)


def parse_mesh(text: str) -> tuple:
    """"P" or "P,S" -> (P,) or (P, S)."""
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        raise ValueError(f"--mesh takes P or P,S (integers), got {text!r}") from None
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"--mesh takes P or P,S (positive integers), got {text!r}")
    return shape


def batch_for_mesh(batch: int, mesh) -> int:
    """The batched path's samples a batch, rounded down to a multiple of the
    mesh's sample shards S (at least S): each batch must divide evenly over
    the sample axis (JAX cli.py:327-335)."""
    if mesh is None:
        return batch
    return max(mesh.samples, (batch // mesh.samples) * mesh.samples)


def _join_ranks(args, mesh_shape):
    """Join the process group under torchrun (WORLD_SIZE > 1) or with
    --multihost; build the mesh of `mesh_shape` (none for ()). -> (mesh or
    None, rank)."""
    import torch.distributed as dist

    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    if (args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1) and not dist.is_initialized():
        pdist.init_distributed(coordinator=args.coordinator, num_processes=args.num_processes,
                               process_id=args.process_id)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return (pdist.make_mesh(mesh_shape) if mesh_shape else None), rank


def _logger(rank: int):
    return _log if rank == 0 else (lambda *a: None)


def resolve_backend(backend: str, platform: str = "auto") -> str:
    """The backend that `--backend` runs on `--platform`. `cuda` or `jnp`
    without a GPU raises unless the platform is `cpu`: the CLI never falls
    back to the CPU by itself. On `cpu`, `cuda` runs as `torch`."""
    if platform == "cpu":
        return "torch" if backend == "cuda" else backend
    if backend == "torch":
        if platform == "gpu":
            raise ValueError("--backend torch runs on the CPU; --platform gpu asks for the GPU")
        return backend
    if not torch.cuda.is_available():
        raise RuntimeError(f"--backend {backend} needs a CUDA GPU, and torch sees none (--platform cpu "
                           f"runs {'the plain version' if backend == 'cuda' else 'it'} on the CPU)")
    return backend


def backend_device(backend: str, platform: str = "auto") -> torch.device:
    """The render device of a resolved backend: the current GPU for `cuda`,
    and for `jnp` unless the platform is `cpu`; else the CPU."""
    on_gpu = backend == "cuda" or (backend == "jnp" and platform != "cpu")
    return torch.device("cuda") if on_gpu else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class CliResult:
    config: RenderConfig
    backend: str
    image: torch.Tensor  # [H, W, 3] float32, linear, on the render device
    first_s: float  # monolithic: the first render, kernel build included; batched: the first batch
    render_s: float  # monolithic: the timed (second) render; batched: this session's batches
    warm_hit: bool  # the timed render ran the cached warm schedule (never on the batched path)
    batch_s: tuple = ()  # batched path: seconds of each batch of this session, in order
    session_spp: int | None = None  # batched path: samples rendered this session

    @property
    def batches(self) -> int:
        return len(self.batch_s)

    @property
    def mrays_per_s(self) -> float:
        """Primary rays rendered in `render_s` (this session's only, on a
        resumed checkpoint) a second, in millions; 0 when nothing was."""
        spp = self.config.samples_per_pixel if self.session_spp is None else self.session_spp
        if self.render_s <= 0:
            return 0.0
        return self.config.image_width * self.config.image_height * spp / self.render_s / 1e6


def run(argv=None) -> CliResult:
    """Parse `argv`, render, time, and write the PPM (and `--png`) unless
    --no-output. Renders in sample batches with one progress line each when
    `--checkpoint` is given, or at spp >= 64 without `--no-progress` and
    `--profile`; in one piece otherwise."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    # On the GPU the device is the current one: a rank's own, which
    # init_distributed chose.
    backend = resolve_backend(config.backend, args.platform)
    device = backend_device(backend, args.platform)
    mesh, rank = _join_ranks(args, config.mesh_shape)
    log = _logger(rank)
    log(f"renderer: {config.image_width}x{config.image_height} "
        f"spp={config.samples_per_pixel} depth={config.max_depth} "
        f"scene={config.scene} seed={config.seed}")
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"backend: {backend} on {device_name} mesh="
        + (f"{mesh.pixels}x{mesh.samples}" if mesh is not None else "1-device"))
    if mesh is not None:
        mesh.build_kernels(device)

    scene = make_scene_from_config(config, device)
    cam = make_camera_from_config(config, device)
    # Long renders report progress (the reference streams "Scanlines
    # remaining", reference: src/cpu/main.cc:112) through the same
    # sample-batched accumulation the checkpoint path uses. The sample
    # streams are the monolithic render's; the mean differs from it only
    # by float summation order (utils/checkpoint.py).
    batched = args.checkpoint or (
        not args.no_progress and not args.profile and config.samples_per_pixel >= 64)
    run_path = _run_batched if batched else _run_monolithic
    result = run_path(args, config, backend, scene, cam, device, mesh, log)

    if not args.no_output and rank == 0:
        u8 = to_uint8(result.image).cpu().numpy()
        if args.png:
            write_png(u8, args.png)
            log(f"wrote {args.png}")
        if args.out == "-":
            ppm.write_ppm(u8, sys.stdout.buffer)
            sys.stdout.buffer.flush()
        else:
            ppm.write_ppm(u8, args.out)
            log(f"wrote {args.out}")
    return result


def _sync(device, mesh):
    """The completion barrier: this device, then every rank's."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        mesh.barrier()


def _run_monolithic(args, config, backend, scene, cam, device, mesh, log) -> CliResult:
    """One warm-up render, then the timed one (under --profile, traced)."""

    def render():
        if backend == "jnp":
            if mesh is not None:
                from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import render_image_distributed

                img = render_image_distributed(scene, cam, config.seed, mesh, config.chunk_pixels)
            else:
                img = render_image(scene, cam, config.seed, config.chunk_pixels)
            _sync(device, mesh)
            return img
        kw = dict(seed=config.seed, tile=args.tile, warm=not args.cold)
        if mesh is not None:
            img = render_cuda_distributed(scene, cam, mesh=mesh, **kw)
        else:
            img = render_cuda(scene, cam, **kw)
        _sync(device, mesh)
        return img

    def timed_render():
        """(image, seconds of the render to its synchronize)."""
        t0 = time.perf_counter()
        img = render()
        return img, time.perf_counter() - t0

    def check_frame(result):
        if not bool(torch.isfinite(result[0]).all()):
            raise RuntimeError("non-finite pixels in rendered frame")

    def render_with_retries():
        """The timed render with the batched path's recovery contract
        (utils/resilient.py): the sample streams are pure functions of
        global indices, so a re-render after a transient device fault or a
        non-finite frame is bit-identical. -> (image, seconds of the render
        that made it): the finiteness check and failed attempts fall
        outside the timed span."""
        return with_retries(timed_render, check_frame, max_retries=max(0, args.retries),
                            what="render", log=log)

    t0 = time.perf_counter()
    render()
    first_s = time.perf_counter() - t0
    log(f"first render (kernel build included): {first_s:.2f}s")
    warm_hit = backend != "jnp" and not args.cold and warm_cache_hit(
        scene, cam, seed=config.seed, tile=args.tile, mesh=mesh)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            img, render_s = render_with_retries()
        if mesh is None or mesh.rank == 0:
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(trace)
            log(f"profile trace written to {trace}")
    else:
        img, render_s = render_with_retries()
    result = CliResult(config, backend, img, first_s, render_s, warm_hit)
    schedule = "persistent grid, pixel queue" if backend == "jnp" else f"{'warm' if warm_hit else 'cold'} schedule"
    log(f"render: {render_s:.3f}s  ({result.mrays_per_s:.2f} Mrays/s, {schedule})")
    return result


def _run_batched(args, config, backend, scene, cam, device, mesh, log) -> CliResult:
    """Progressive accumulation (utils/checkpoint.py) with one progress line
    a batch. With --checkpoint the state resumes from and is saved to the
    file after every batch (by rank 0 on a mesh); with --retries a failed
    or non-finite batch is rendered again (utils/resilient.py)."""
    if args.checkpoint and os.path.exists(args.checkpoint):
        state = ckpt.load(args.checkpoint, device=device)
        validate_state(state)  # corrupt on disk fails fast, distinctly
        shape = (cam.image_height, cam.image_width, 3)
        if tuple(state.accum.shape) != shape:
            raise ValueError(f"{args.checkpoint} holds a {list(state.accum.shape)} image, "
                             f"this render is {list(shape)}")
        log(f"resumed {args.checkpoint} at {state.spp_done} spp")
    else:
        state = ckpt.new_state(cam, device=device)
    if mesh is not None:
        mesh.barrier()  # every rank has read the checkpoint before rank 0 writes it

    target_spp = config.samples_per_pixel
    batch = batch_for_mesh(args.spp_batch or max(1, target_spp // 10), mesh)
    start_spp = state.spp_done  # session accounting (resume-aware)
    batch_s = []
    while state.spp_done < target_spp:
        n = min(batch, target_spp - state.spp_done)
        t0 = time.perf_counter()
        kw = dict(tile=args.tile, warm=not args.cold, mesh=mesh, backend=backend,
                  chunk_size=config.chunk_pixels)
        if args.retries > 0:
            state = accumulate_resilient(state, scene, cam, config.seed, n, max_retries=args.retries,
                                         log=log, **kw)
        else:
            state = ckpt.accumulate(state, scene, cam, config.seed, n, **kw)
        _sync(device, mesh)  # completion barrier
        if args.checkpoint and (mesh is None or mesh.rank == 0):
            ckpt.save(state, args.checkpoint)
        dt = time.perf_counter() - t0
        batch_s.append(dt)
        done = state.spp_done
        # Steady rate from THIS SESSION's batches after the first (which
        # builds the kernels; resumed samples are not this session's).
        session = done - start_spp
        if session > batch:
            steady = (sum(batch_s) - batch_s[0]) / (session - batch)
        else:
            steady = dt / max(n, 1)
        log(f"samples {done}/{target_spp} (+{n} in {dt:.2f}s, "
            f"~{(target_spp - done) * steady:.0f}s remaining)")
    session = state.spp_done - start_spp
    result = CliResult(config, backend, state.image, batch_s[0] if batch_s else 0.0,
                       sum(batch_s), False, tuple(batch_s), session)
    if session > 0 and result.render_s > 0:
        log(f"render: {result.render_s:.3f}s total for {session} spp "
            f"({result.mrays_per_s:.2f} Mrays/s incl compile)")
    else:
        log(f"checkpoint already complete at {state.spp_done} spp")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
