"""Local multi-rank runs: one process a rank, each running named jobs.

    python -m ray_tracing_in_one_weekend_tpu_torch.parallel.worker DIR

`launch` starts one such process a rank on this host, with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT on a free local port). Each rank joins the process group
(`dist.init_distributed`), reads the jobs from DIR/spec.pt, runs them in
order on its own mesh of each job's shape, and writes its results to
DIR/rank{r}.pt. On the card rank 0 builds the kernels before the others
load them. Every launch has a timeout; a rank that fails or outlives it
stops every rank, and `launch` raises with the ranks' logs.

A job is a dict: `job` (a name of `JOBS`), `mesh` ((P,) or (P, S)),
`scene` and `camera` (`scene_spec`, `camera_spec`), and job keywords:

* "render": `render_cuda_distributed` `repeat` times (default 1) with
  `kw`; the first call's image and cost map, whether each later call gave
  the same bits, and each call's seconds, collectives' seconds and
  whether it hit the warm cache.
* "step": `render_grads_cuda` on the mesh `repeat` times with `kw`, the
  scene's own parameters and `target` (None: zeros); the first call's
  loss, gradients and cost map, whether each later call gave the same
  bits, and each call's seconds and collectives' seconds.
* "autograd_step": `dist.render_grads_pcg` (torch.autograd through the
  plain render on the PCG streams) on the mesh, as "step" with the same
  layout; it has no cost map, so `work` is None.
* "keyed_step": `dist.render_grads` (the keyed gradient on threefry keys:
  the kernels on the card, autograd through the plain render on the CPU)
  on the mesh, as "autograd_step", and the step's image,
  `dist.render_distributed(..., differentiable=True)`, in `image`.
* "jnp_render": `dist.render_distributed` (the jnp backend on threefry
  keys) with `kw`; the image and the call's seconds.
* "accumulate": `checkpoint.accumulate` on the mesh, one batch of each
  size in `batches`; the state after each.
* "dryrun": `entry.dryrun_rank` on the mesh.

Each result also holds the kernels' launches in the job (gathered by the
caller from every rank), the process group's backend, and on the card the
peak memory.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from ray_tracing_in_one_weekend_tpu_torch.models.camera import _VECTORS, Camera
from ray_tracing_in_one_weekend_tpu_torch.models.scene import Scene

_ROOT = Path(__file__).resolve().parents[2]
# Launches without a directory of their own write under the checkout's
# ignored build/ directory.
SCRATCH = _ROOT / "build" / "ranks"
_SCENE_FIELDS = ("center", "radius", "albedo", "fuzz", "ior", "mat_type", "active")
_CAMERA_INTS = ("image_width", "image_height", "samples_per_pixel", "max_depth")


class WorkerError(RuntimeError):
    """A rank of a local launch failed or timed out."""


def scene_spec(scene: Scene) -> dict:
    return {f: getattr(scene, f).detach().cpu() for f in _SCENE_FIELDS}


def camera_spec(cam: Camera) -> dict:
    spec = {f: getattr(cam, f) for f in _CAMERA_INTS}
    spec.update({f: getattr(cam, f).detach().cpu() for f in (*_VECTORS, "defocus_angle")})
    return spec


def _scene(spec: dict, device) -> Scene:
    return Scene(**{f: spec[f].to(device) for f in _SCENE_FIELDS})


def _camera(spec: dict, device) -> Camera:
    return Camera(**{f: spec[f] for f in _CAMERA_INTS},
                  **{f: spec[f].to(device) for f in (*_VECTORS, "defocus_angle")})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(jobs: list, n_ranks: int, out_dir, *, device: str, backend: str | None = None,
           timeout: float = 120.0, threads: int = 2) -> list:
    """Run `jobs` on `n_ranks` local ranks -> each rank's list of results,
    in rank order. `device` "cpu" or "cuda" (every rank on
    LOCAL_RANK % device_count), required: no entry point picks the CPU
    unless asked; `backend` None lets `init_distributed`
    choose. Each rank runs with at most `threads` torch threads. Raises
    `WorkerError` if a rank exits non-zero or the launch outlives
    `timeout` seconds; either way no rank is left running."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for r in range(n_ranks):
        (out / f"rank{r}.pt").unlink(missing_ok=True)
    torch.save({"jobs": jobs, "device": device, "backend": backend, "threads": threads},
               out / "spec.pt")
    env = dict(os.environ)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n_ranks),
               LOCAL_WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join(filter(None, [str(_ROOT), env.get("PYTHONPATH")])))
    procs, logs = [], []
    try:
        for r in range(n_ranks):
            log = open(out / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ray_tracing_in_one_weekend_tpu_torch.parallel.worker", str(out)],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
                stderr=subprocess.STDOUT, cwd=_ROOT,
            ))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                raise WorkerError(f"rank {failed[0]} exited {procs[failed[0]].returncode}"
                                  + _tails(out, n_ranks))
            if time.monotonic() > deadline:
                raise WorkerError(f"the launch outlived its timeout of {timeout:.0f} s"
                                  + _tails(out, n_ranks))
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise WorkerError(f"rank {failed[0]} exited {procs[failed[0]].returncode}"
                              + _tails(out, n_ranks))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [torch.load(out / f"rank{r}.pt")["results"] for r in range(n_ranks)]


def _tails(out: Path, n_ranks: int, n_bytes: int = 3000) -> str:
    parts = []
    for r in range(n_ranks):
        path = out / f"rank{r}.log"
        text = path.read_text(errors="replace") if path.exists() else ""
        parts.append(f"\n--- rank {r} ---\n{text[-n_bytes:]}")
    return "".join(parts)


# ---------------------------------------------------------------------------
# The jobs, run on every rank.
# ---------------------------------------------------------------------------


def _launch_counts():
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    return dict(build.LAUNCHES)


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launch_counts().items()}


def _sync(device, mesh):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mesh.barrier()


def _job_render(job, mesh, device):
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

    scene, cam = _scene(job["scene"], device), _camera(job["camera"], device)
    kw = job.get("kw", {})
    hit_kw = {k: v for k, v in kw.items() if k in ("seed", "tile", "spp", "sample_offset")}
    res = {"same": [], "seconds": [], "collective_s": [], "hits": []}
    for i in range(job.get("repeat", 1)):
        res["hits"].append(cr.warm_cache_hit(scene, cam, mesh=mesh, **hit_kw))
        _sync(device, mesh)
        c0, t0 = mesh.seconds["collectives"], time.perf_counter()
        img, work = cr.render_cuda_distributed(scene, cam, mesh=mesh, return_work=True, **kw)
        _sync(device, mesh)
        res["seconds"].append(time.perf_counter() - t0)
        res["collective_s"].append(mesh.seconds["collectives"] - c0)
        if i == 0:
            first = img
            res["image"], res["work"] = img.cpu(), work.cpu()
        else:
            res["same"].append(torch.equal(img, first))
    return res


def _kernel_grads(params, scene, cam, target, mesh, **kw):
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    return cg.render_grads_cuda(params, scene, cam, target, mesh=mesh, return_work=True, **kw)


def _dist_grads(name):
    """`parallel.dist`'s `name` (a function with no cost map) as a step's
    gradient function."""

    def grads_fn(params, scene, cam, target, mesh, **kw):
        from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

        loss, grads = getattr(pdist, name)(params, scene, cam, target, mesh=mesh, **kw)
        return (loss, None), grads

    return grads_fn


def _job_step(job, mesh, device, grads_fn=_kernel_grads):
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg

    scene, cam = _scene(job["scene"], device), _camera(job["camera"], device)
    target = job.get("target")
    target = (torch.zeros(cam.image_height, cam.image_width, 3, device=device) if target is None
              else target.to(device))
    params = cg.scene_params(scene)
    res = {"same": [], "seconds": [], "collective_s": []}
    for i in range(job.get("repeat", 1)):
        _sync(device, mesh)
        c0, t0 = mesh.seconds["collectives"], time.perf_counter()
        (loss, work), grads = grads_fn(params, scene, cam, target, mesh, **job.get("kw", {}))
        _sync(device, mesh)
        res["seconds"].append(time.perf_counter() - t0)
        res["collective_s"].append(mesh.seconds["collectives"] - c0)
        if i == 0:
            first = (loss, grads)
            res["loss"], res["work"] = loss.cpu(), None if work is None else work.cpu()
            res["grads"] = {k: v.cpu() for k, v in grads.items()}
        else:
            res["same"].append(torch.equal(loss, first[0])
                               and all(torch.equal(v, first[1][k]) for k, v in grads.items()))
    return res


def _job_accumulate(job, mesh, device):
    from ray_tracing_in_one_weekend_tpu_torch.utils import checkpoint as ckpt

    scene, cam = _scene(job["scene"], device), _camera(job["camera"], device)
    state = ckpt.new_state(cam, device=device)
    res = {"accums": [], "spp_done": []}
    for n in job["batches"]:
        state = ckpt.accumulate(state, scene, cam, job.get("seed", 0), n, mesh=mesh,
                                **job.get("kw", {}))
        res["accums"].append(state.accum.cpu())
        res["spp_done"].append(state.spp_done)
    return res


def _job_jnp_render(job, mesh, device):
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    scene, cam = _scene(job["scene"], device), _camera(job["camera"], device)
    _sync(device, mesh)
    t0 = time.perf_counter()
    img = pdist.render_distributed(scene, cam, mesh=mesh, **job.get("kw", {}))
    _sync(device, mesh)
    return {"image": img.cpu(), "seconds": [time.perf_counter() - t0]}


def _job_dryrun(job, mesh, device):
    from ray_tracing_in_one_weekend_tpu_torch import entry

    return entry.dryrun_rank(mesh, device)


def _job_autograd_step(job, mesh, device):
    return _job_step(job, mesh, device, _dist_grads("render_grads_pcg"))


def _job_keyed_step(job, mesh, device):
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    res = _job_step(job, mesh, device, _dist_grads("render_grads"))
    scene, cam = _scene(job["scene"], device), _camera(job["camera"], device)
    kw = {k: v for k, v in job.get("kw", {}).items() if k in ("base_key", "chunk_size", "spp")}
    res["image"] = pdist.render_distributed(scene, cam, mesh=mesh, differentiable=True, **kw).detach().cpu()
    return res


JOBS = {"render": _job_render, "step": _job_step, "autograd_step": _job_autograd_step,
        "keyed_step": _job_keyed_step,
        "jnp_render": _job_jnp_render, "accumulate": _job_accumulate, "dryrun": _job_dryrun}


def main(argv=None) -> int:
    from ray_tracing_in_one_weekend_tpu_torch.parallel import dist as pdist

    out = Path((argv or sys.argv[1:])[0])
    spec = torch.load(out / "spec.pt")
    torch.set_num_threads(spec["threads"])
    pdist.init_distributed(backend=spec["backend"])
    rank = torch.distributed.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda" \
        else torch.device("cpu")
    results = []
    try:
        for i, job in enumerate(spec["jobs"]):
            mesh = pdist.make_mesh(tuple(job["mesh"]))
            if i == 0:
                mesh.build_kernels(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = _launch_counts()
            res = JOBS[job["job"]](job, mesh, device)
            res["launches"] = _since(before)
            res["mesh"] = (mesh.pixels, mesh.samples)
            res["backend"] = torch.distributed.get_backend()
            if device.type == "cuda":
                res["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            results.append(res)
        torch.save({"results": results}, out / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
