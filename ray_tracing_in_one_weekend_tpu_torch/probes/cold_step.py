"""The first train step of a process, cold, in fresh processes: this tree
and another checkout of the port in turns, and this tree after the
checks that precede the step in chip_smoke.py.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.cold_step [--rounds 3] [--parent DIR]

Each run is a new Python process started from the root of its tree. It
makes the CUDA context, builds (or finds built) and loads its tree's
kernels, makes the bench preset (cover scene, 1200x800, 10 spp, depth 50,
zero target), and then times by the host clock to a synchronize: the
first `render_grads_cuda` step (the cold render schedule, the kernels'
first launches, the allocator's first blocks), the same cold-schedule
step again, and three warm steps with the work_hint carry. It also counts
the device-memory segments the allocator took and the bytes it reserved
during the first step (`torch.cuda.memory_stats`). The runs of a round
are: the parent (with `--parent`); this tree; this tree after a prelude
like chip_smoke.py's phase 7b checks, `_reduce_events_ordered` and
`grad_reduce` on 448,287 synthetic events for 512 spheres (phase 7b's
count); and the same prelude followed by `torch.cuda.empty_cache()`.
Rounds alternate the order (A B C D, then D C B A). Prints one line a run
and the median of each kind, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PRELUDE_EVENTS, PRELUDE_SPHERES = 448287, 512


def _child(root: Path, prelude: str) -> dict:
    """One run, in this process (a fresh one): the timings of the module
    docstring for the tree at `root`."""
    sys.path[0] = str(root)  # the tree's package, not this script's directory
    import torch

    from ray_tracing_in_one_weekend_tpu_torch.kernels import build
    from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_grad as cg
    from ray_tracing_in_one_weekend_tpu_torch.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    build.load()
    if prelude != "none":
        from ray_tracing_in_one_weekend_tpu_torch.probes import synthetic_events

        ev = synthetic_events(PRELUDE_EVENTS, PRELUDE_SPHERES, seed=0, device=dev)
        got = build.grad_reduce(ev, PRELUDE_SPHERES)
        if not torch.equal(got.view(torch.int32), cg._reduce_events_ordered(ev, PRELUDE_SPHERES).view(torch.int32)):
            raise RuntimeError("the prelude's grad_reduce differs from _reduce_events_ordered")
        del ev, got
        if prelude == "ordered, empty_cache":
            torch.cuda.empty_cache()
    config = PRESETS["bench"]
    scene, cam = make_scene_from_config(config, dev), make_camera_from_config(config, dev)
    params = cg.scene_params(scene)
    target = torch.zeros(cam.image_height, cam.image_width, 3, device=dev)
    torch.cuda.synchronize()

    def timed(**kw):
        t0 = time.perf_counter()
        out = cg.render_grads_cuda(params, scene, cam, target, return_work=True, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    before = torch.cuda.memory_stats()
    cold_ms, ((_, work), _) = timed()
    after = torch.cuda.memory_stats()
    again_ms, _ = timed()
    warm = []
    for _ in range(3):
        ms, ((_, work), _) = timed(work_hint=work)
        warm.append(ms)
    return {"cold_ms": cold_ms, "again_ms": again_ms, "warm_ms": warm,
            "segments": after["segment.all.allocated"] - before["segment.all.allocated"],
            "reserved_gb": (after["reserved_bytes.all.allocated"] - before["reserved_bytes.all.allocated"]) / 1e9}


def _run(root: Path, prelude: str) -> dict:
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(root), prelude],
                          cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"cold_step run in {root} ({prelude}) exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    if argv is None and len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(_child(Path(sys.argv[2]), sys.argv[3])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None, help="another checkout of the port, run in turns")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cold_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi

    smi = nvidia_smi()
    kinds = [("this tree", REPO, "none"), ("this tree after the ordered checks", REPO, "ordered"),
             ("this tree after the ordered checks and empty_cache", REPO, "ordered, empty_cache")]
    if args.parent is not None:
        kinds.insert(0, ("parent", args.parent.resolve(), "none"))
    runs: dict[str, list[dict]] = {label: [] for label, _, _ in kinds}
    for k in range(args.rounds):
        for label, root, prelude in kinds if k % 2 == 0 else kinds[::-1]:
            r = _run(root, prelude)
            runs[label].append(r)
            print(f"round {k} {label}: cold step {r['cold_ms']:.2f} ms, again {r['again_ms']:.2f} ms, warm "
                  + ", ".join(f"{t:.2f}" for t in r["warm_ms"])
                  + f" ms; the cold step took {r['segments']} segments, {r['reserved_gb']:.3f} GB [{smi}]",
                  flush=True)
    for label, rs in runs.items():
        print(f"{label}: median of {len(rs)} fresh processes: cold step "
              f"{statistics.median(r['cold_ms'] for r in rs):.2f} ms (min {min(r['cold_ms'] for r in rs):.2f}, "
              f"max {max(r['cold_ms'] for r in rs):.2f}), again {statistics.median(r['again_ms'] for r in rs):.2f} "
              f"ms, best warm {statistics.median(min(r['warm_ms']) for r in rs):.2f} ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
