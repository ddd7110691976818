"""The benchmark's command: one run of one cell, in this process.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It sets up the cell (kernels from the
port's compile cache under build/kernels/, the scene, one frame or step of
the cell's own shapes), measures for --seconds (--trace 0: the cell's
end-to-end metrics; --trace 1: its per-layer metrics under torch.profiler),
checks what the window produced against the plain reference, and prints
one JSON line last on standard output, with the numbers compared last on
standard error too. Without CUDA, or with fewer cards than the cell asks
for, or with JAX or the JAX package loaded, it prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from rtbench import harness  # noqa: E402

_AGE = harness.process_seconds()
# The process's start on the perf_counter clock: set-up is counted from it.
PROCESS_START = _T0 - (_AGE if _AGE is not None else 0.0)


def _caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    build = harness.ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    cell = harness.Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s), torch sees {have}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print(f"rtbench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    result["device"]["power_limit"] = harness.nvidia_smi("name,power.limit")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
