"""chain_fma_kernel's design on the card: its steps a trip and its elements
a thread, and the parent tree's kernel beside them.

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.chain_variants [--rounds 7] [--parent DIR]

Builds csrc/probe_kernels.cu once per (CHAIN_UNROLL, CHAIN_ELEMS) of
VARIANTS other than the committed pair, each from a copy of csrc/ under
build/chain_variants/ with the two constants rewritten (the committed
source has no build switch), all nvcc started together; the committed
kernel is `kernels/build.py`'s, and with `--parent` the parent checkout's
by its own `kernels/build.py`. For each it prints its registers and its
main loop's SASS (`kernel_parts.chain_reading`), and times one launch of
512 steps at 2048 and at 131072 columns (`kernel_parts.inputs`) by CUDA
events, every build in turns in each of `--rounds` rounds, with
fma_peak_kernel at the same operations (the floor a launch of that size
meets) and the SM clock and power nvidia-smi read meanwhile; it prints the
best and the median of each. Every build's output must equal the
committed kernel's bit for bit on seeded inputs at 2048 columns (512
steps) and at [128, 196] (1000 steps). Needs one CUDA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.kernels import build
from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms, nvidia_smi, smi_samples
from ray_tracing_in_one_weekend_tpu_torch.probes import kernel_parts as kp
from ray_tracing_in_one_weekend_tpu_torch.probes import sweep_readings as sr
from ray_tracing_in_one_weekend_tpu_torch.probes.sweep_variants import smi_summary

# (CHAIN_UNROLL, CHAIN_ELEMS): one to eight elements a thread, 32 to 256
# steps a trip.
VARIANTS = ((32, 4), (64, 4), (128, 4), (256, 4), (64, 2), (128, 2), (64, 8), (128, 8), (128, 1))
VARIANT_DIR = build.BUILD_DIR.parent / "chain_variants"


def variant_source(unroll: int, elems: int) -> str:
    text = kp.CHAIN_SOURCE.read_text()
    values = {"CHAIN_UNROLL": unroll, "CHAIN_ELEMS": elems}
    return kp.CHAIN_CONSTANT.sub(lambda m: f"constexpr int {m.group(1)} = {values[m.group(1)]};", text)


def build_variants(variants) -> dict:
    """{(unroll, elems): (library path, nvcc log)}, all built side by side."""
    jobs = {}
    for v in variants:
        root = VARIANT_DIR / f"u{v[0]}_e{v[1]}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, root / "csrc")
        src = root / "csrc" / kp.CHAIN_SOURCE.name
        src.write_text(variant_source(*v))
        if kp.chain_design(src.read_text()) != {"CHAIN_UNROLL": v[0], "CHAIN_ELEMS": v[1]}:
            raise RuntimeError(f"variant {v}: the constants were not rewritten")
        jobs[v] = (root / "librt_chain.so", src)
    logs = build._run_all([[build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib), str(src)]
                           for lib, src in jobs.values()])
    return {v: (lib, log) for (v, (lib, _)), log in zip(jobs.items(), logs)}


def launcher(lib_path: Path):
    """chain(x, steps) -> out through the `rt_chain_fma` of a variant's library."""
    lib = ctypes.CDLL(str(lib_path))
    lib.rt_chain_fma.restype = ctypes.c_int
    lib.rt_chain_fma.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]

    def chain(x, steps):
        out = torch.empty_like(x)
        err = lib.rt_chain_fma(x.data_ptr(), out.data_ptr(), x.numel(), int(steps),
                               torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rt_chain_fma of {lib_path} failed: CUDA error {err}")
        return out

    return chain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--parent", type=Path, default=None, help="another checkout of the port, timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    committed = kp.chain_design()
    mine = (committed["CHAIN_UNROLL"], committed["CHAIN_ELEMS"])

    res = build.build()
    build.load()
    chains = {f"committed U {mine[0]} E {mine[1]}": build.chain_fma}
    print(f"committed U {mine[0]} E {mine[1]}: {kp.chain_reading(res.log, sr.sass_of(res.path)).line()}",
          flush=True)
    for (u, e), (lib, log) in build_variants([v for v in VARIANTS if v != mine]).items():
        print(f"U {u} E {e}: {kp.chain_reading(log, sr.sass_of(lib)).line()}", flush=True)
        chains[f"U {u} E {e}"] = launcher(lib)
    if args.parent is not None:
        mod = sr.load_build(args.parent)
        res = mod.build()
        print(f"parent {args.parent}: {kp.chain_reading(res.log, sr.sass_of(res.path)).line()}", flush=True)
        chains[f"parent {args.parent}"] = mod.chain_fma

    rng = np.random.default_rng(0)
    checks = [(torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)).to(dev), steps)
              for shape, steps in (((128, kp.JAX_TILE), kp.CHAIN), ((128, 196), 1000))]
    want = [build.chain_fma(x, steps) for x, steps in checks]
    for label, chain in chains.items():
        for (x, steps), w in zip(checks, want):
            if not torch.equal(chain(x, steps), w):
                raise RuntimeError(f"{label}: other bits than the committed kernel at {tuple(x.shape)}, "
                                   f"{steps} steps")

    tiles = (kp.JAX_TILE, kp.FILL_TILE)
    xs = {t: kp.inputs("chain_fma", t, dev)[0] for t in tiles}
    peak = {t: kp.inputs("fma_peak", t, dev) for t in tiles}
    # fma_peak at the chain's operations: 64 x tile x reps x 16 = 128 x tile x 512.
    peak_reps = 128 * kp.CHAIN // (64 * kp.FMA_UNROLL)
    bounds = {t: kp.bound_ms(*kp.work("chain_fma", (xs[t],), kp.CHAIN)[:2])[0] for t in tiles}
    launches = {kp.JAX_TILE: 20, kp.FILL_TILE: 5}
    times = {label: {t: [] for t in tiles} for label in (*chains, "fma_peak")}
    with smi_samples() as smi_lines:
        for _ in range(args.rounds):
            for t in tiles:
                for label, chain in chains.items():
                    chain(xs[t], kp.CHAIN)
                    times[label][t].append(cuda_ms(lambda: chain(xs[t], kp.CHAIN), reps=launches[t]))
                kp.fma_peak(*peak[t], peak_reps)
                times["fma_peak"][t].append(cuda_ms(lambda: kp.fma_peak(*peak[t], peak_reps), reps=launches[t]))
    for label, by_tile in times.items():
        what = f"fma_peak_kernel (reps {peak_reps}, the same operations)" if label == "fma_peak" else label
        print(f"{what}: best / median of {args.rounds} rounds " + "; ".join(
            f"{t} columns {min(v):.5f} / {statistics.median(v):.5f} ms ({100 * bounds[t] / min(v):.1f}% of "
            f"{bounds[t]:.5f} ms at best)" for t, v in by_tile.items()) + f" [{smi}]", flush=True)
    print(smi_summary(smi_lines, smi), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
