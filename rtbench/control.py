"""The control of a cell's check: the plain reference computed in bfloat16,
the precision below the configuration's float32, put in the program's
place, beside the program's own readings, over several seeds in one
process (the benchmark's own runs never run it).

    python3 -m rtbench.control --workload <name> --seeds 1,2,3 [--seconds 3] [--fault NAME] [--control 0]

For each seed it sets the cell up, runs a short window of the cell's own
load, and prints one JSON line: for the program and for the control, each
number the check compares beside its limit (`limits/<workload>.json`) and
the verdict `correct` that the harness's run gives them. With `--fault`
the program runs with that fault of `rtbench.faults` planted underneath
once set-up has ended, and only its numbers are read; `--control 0` reads
the sound program's numbers alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from rtbench import faults, harness


def _judged(numbers: dict, limits: dict) -> dict:
    """`numbers` each beside its limit, and the verdict the harness gives."""
    checks = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items()}
    failed, correct = harness.judge(checks)
    return {"correct": correct, "failed": failed, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=faults.FAULTS, default=None, help="plant this fault once set-up has ended")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1, help="0: the program's numbers alone")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rtbench.control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(args.workload)
        with contextlib.ExitStack() as stack:
            driver_class = cell.driver_class()
            if args.fault is not None:
                driver_class = faults.after_setup(driver_class, args.fault, stack)
            driver = driver_class(cell, seed, device)
            t0 = time.perf_counter()
            driver.setup()
            harness.measure(driver, args.seconds, device)
            t1 = time.perf_counter()
            out = driver.check(control=bool(args.control) and args.fault is None)
        if "program" not in out:
            out = {"program": {k: v["value"] for k, v in out.items()}}
        out = {side: _judged(numbers, cell.limits) for side, numbers in out.items()}
        out.update(workload=args.workload, seed=seed, fault=args.fault, run_s=t1 - t0,
                   check_s=time.perf_counter() - t1, peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        print(json.dumps(out), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
