"""Time the forward kernel's component costs in isolation (roofline input).

    python -m ray_tracing_in_one_weekend_tpu_torch.probes.kernel_parts [tile] [reps]

The port of the JAX package's scripts/kernel_parts_probe.py. Each part is
a probe kernel of `csrc/probe_kernels.cu`, run on `tile` columns (default
2048, the script's) and on FILL_TILE columns, enough to fill the card's
132 SMs, with `reps` iterations per launch (default 64):

* fma-peak: 8 independent chains of fused multiply-adds per column, the
  card's float32 rate on this code;
* sweep: the render kernel's own closest-hit sweep over the cover scene's
  512 slots, without the scatter;
* gather: the TPU kernel's one-hot product [16, N] @ [N, tile] (the render
  kernel here loads the winner's row by index instead);
* skinny-highest: the K=8 product [2N, 8] @ [8, tile] in float32.

For each part it prints the time, the rate, the microseconds per
2048-column rep (the script's "tile-iteration"), and the part's bound
against the published H100 peaks (67 TFLOP/s float32, 3.35 TB/s); for the
two products also the time of `torch.matmul` on the same product (TF32
off, and for the skinny one on). It needs one CUDA GPU with nvcc.

The module also holds the plain PyTorch version of every probe kernel,
the chain of scripts/perf_probe.py included, and the dispatchers
(`chain_fma`, `fma_peak`, `sweep`, `gather`, `skinny`) that launch the
kernel for CUDA tensors and run the plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ray_tracing_in_one_weekend_tpu_torch.models.scene import cover_scene
from ray_tracing_in_one_weekend_tpu_torch.ops import cuda_render as cr

# Published H100 SXM peaks (NVIDIA's data sheet), at a 700 W power limit.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of one sphere test in `closest_hit`
# (csrc/render_device.cuh): d.c 5, cc_part 6, half_b 1, cc 1, disc 2.
OPS_PER_SPHERE_TEST = 15
# ... and of a test whose quadratic has real roots, on top: sqrt, the two
# roots, and the three compares that pick t.
OPS_PER_REAL_ROOT = 6

CHAIN = 512  # steps of the chain probe (scripts/perf_probe.py:44)
FMA_ACCS, FMA_UNROLL = 8, 16  # scripts/kernel_parts_probe.py:64-65
JAX_TILE = 2048  # the scripts' default tile
FILL_TILE = 131072  # columns that fill 132 SMs several times over
PARTS = ("fma_peak", "sweep_probe", "gather_probe", "skinny_probe")

# The fused step acc * 1.0000001 + 1e-7 with float32 constants. The plain
# version takes it in float64 (the product of two float32 is exact there)
# and rounds to float32: a second rounding that differs from the kernel's
# single one only when the float64 sum falls on a float32 tie.
_MUL = float(np.float32(1.0000001))
_ADD = float(np.float32(1e-7))


def _fma_step(acc: torch.Tensor) -> torch.Tensor:
    return (acc.double() * _MUL + _ADD).float()


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def chain_fma_plain(x: torch.Tensor, chain: int = CHAIN) -> torch.Tensor:
    """x [R, tile] -> [R, tile]: `chain` fused steps per element."""
    acc = x
    for _ in range(chain):
        acc = _fma_step(acc)
    return acc


def fma_peak_plain(x: torch.Tensor, reps: int) -> torch.Tensor:
    """x [64, tile] -> [8, tile]: accumulators x[8i:8i+8] + i, each `reps`
    x 16 fused steps, summed in order."""
    accs = x.reshape(FMA_ACCS, 8, -1) + torch.arange(FMA_ACCS, dtype=x.dtype, device=x.device)[:, None, None]
    for _ in range(reps * FMA_UNROLL):
        accs = _fma_step(accs)
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def sweep_plain(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor, reps: int,
                t_min: float = cr.T_MIN_EPS) -> torch.Tensor:
    """Pᵀ [N, 16] (the transposed packed scene, the kernel's table), o, d
    [3, tile] (d unit) -> [1, tile]: `reps` times the nearest t over every
    sphere (`_sweep_ts` + min), o += 1e-9 t, summed."""
    p_mat = table.T
    acc = torch.zeros_like(o[0:1])
    for _ in range(reps):
        t_best = cr._sweep_ts(o, d, p_mat, t_min).amin(dim=0, keepdim=True)
        o = o + 1e-9 * t_best
        acc = acc + t_best
    return acc


def gather_plain(p: torch.Tensor, oh: torch.Tensor, reps: int) -> torch.Tensor:
    """P [16, N], OH [N, tile] -> [1, tile]: `reps` times row 0 of P @ OH,
    OH += 1e-12 row 0, summed."""
    acc = torch.zeros_like(oh[0:1])
    for _ in range(reps):
        row0 = (p @ oh)[0:1]
        oh = oh + 1e-12 * row0
        acc = acc + row0
    return acc


def skinny_plain(l: torch.Tensor, r: torch.Tensor, reps: int) -> torch.Tensor:
    """L [M, 8], R [8, tile] -> [1, tile]: `reps` times row 0 of L @ R,
    R += 1e-12 row 0, summed."""
    acc = torch.zeros_like(r[0:1])
    for _ in range(reps):
        row0 = (l @ r)[0:1]
        r = r + 1e-12 * row0
        acc = acc + row0
    return acc


# ---------------------------------------------------------------------------
# Dispatchers: the kernel for CUDA tensors (it raises if it cannot launch;
# there is no fallback), the plain version for CPU tensors.
# ---------------------------------------------------------------------------


def _build():
    from ray_tracing_in_one_weekend_tpu_torch.kernels import build

    return build


def chain_fma(x, chain=CHAIN):
    return _build().chain_fma(x, chain) if x.is_cuda else chain_fma_plain(x, chain)


def fma_peak(x, reps):
    return _build().fma_peak(x, reps) if x.is_cuda else fma_peak_plain(x, reps)


def sweep(table, o, d, reps, t_min=cr.T_MIN_EPS):
    return _build().sweep_probe(table, o, d, reps, t_min) if o.is_cuda else sweep_plain(
        table, o, d, reps, t_min)


def gather(p, oh, reps):
    return _build().gather_probe(p, oh, reps) if oh.is_cuda else gather_plain(p, oh, reps)


def skinny(l, r, reps):
    return _build().skinny_probe(l, r, reps) if r.is_cuda else skinny_plain(l, r, reps)


# ---------------------------------------------------------------------------
# Inputs, work and bounds.
# ---------------------------------------------------------------------------


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def inputs(name: str, tile: int, device, seed: int = 0) -> tuple:
    """The scripts' inputs for probe `name` at `tile` columns, made with
    numpy from `seed`: ones for the FMA probes; the cover scene's table
    Pᵀ [N, 16] and rays from 3 N(0, 1) points pointing away from the
    origin for the sweep; the cover scene's P [16, N] and a
    one-hot-like OH (uniform < 1/N) for the gather; N(0, 1) L and R for
    the skinny product."""
    rng = np.random.default_rng(seed)
    if name == "chain_fma":
        return (_tensor(np.ones((128, tile)), device),)
    if name == "fma_peak":
        return (_tensor(np.ones((64, tile)), device),)
    p_mat = cr.pack_scene(cover_scene(0, device=device))
    n = p_mat.shape[1]
    if name == "sweep_probe":
        o = rng.standard_normal((3, tile)).astype(np.float32) * np.float32(3.0)
        d = o / np.linalg.norm(o, axis=0, keepdims=True)
        return p_mat.T.contiguous(), _tensor(o, device), _tensor(d, device)
    if name == "gather_probe":
        return p_mat, _tensor(rng.uniform(size=(n, tile)) < 1.0 / n, device)
    if name == "skinny_probe":
        return _tensor(rng.standard_normal((2 * n, 8)), device), _tensor(
            rng.standard_normal((8, tile)), device)
    raise ValueError(f"unknown probe {name!r}")


def run(name: str, args: tuple, reps: int) -> torch.Tensor:
    """Probe `name` on `args` (the kernel on the card, else the plain
    version); the chain probe takes `reps` as its chain length."""
    fn = {"chain_fma": chain_fma, "fma_peak": fma_peak, "sweep_probe": sweep,
          "gather_probe": gather, "skinny_probe": skinny}[name]
    return fn(*args, reps)


def run_plain(name: str, args: tuple, reps: int) -> torch.Tensor:
    fn = {"chain_fma": chain_fma_plain, "fma_peak": fma_peak_plain, "sweep_probe": sweep_plain,
          "gather_probe": gather_plain, "skinny_probe": skinny_plain}[name]
    return fn(*args, reps)


# Gates of each kernel against its plain version on the card (`error`).
# The FMA probes differ only where the plain version's float64 step lands
# on a float32 tie; the sweep runs the render's closest_hit, which the
# -fmad=false build rounds as the plain sweep does; the two products sum in
# another order than torch.matmul.
GATES = {"chain_fma": 1e-6, "fma_peak": 1e-6, "sweep_probe": 1e-6, "gather_probe": 1e-5,
         "skinny_probe": 1e-5}


def error(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The kernel's error against the plain version. For the sweep, per
    lane relative in t, and infinite unless the misses (sums of T_MISS)
    fall on the same lanes; for the others, relative to the largest
    plain value."""
    if name == "sweep_probe":
        if not torch.equal(got >= 1e29, want >= 1e29):
            return float("inf")
        return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    return float(((got - want).abs() / want.abs().amax()).max())


def real_roots(table, o, d, reps, t_min=cr.T_MIN_EPS) -> int:
    """Sphere tests with real roots over the sweep probe's `reps`: the
    data-dependent part of its work."""
    count = 0
    p_mat = table.T
    c = p_mat.unsqueeze(-1)
    for _ in range(reps):
        half_b = cr._dot3(o, d) - (c[cr._CX] * d[0:1] + c[cr._CY] * d[1:2] + c[cr._CZ] * d[2:3])
        cc = cr._dot3(o, o) + (c[cr._CSQR2] + c[cr._M2CX] * o[0:1] + c[cr._M2CY] * o[1:2]
                               + c[cr._M2CZ] * o[2:3])
        count += int((half_b * half_b - cc >= 0.0).sum())
        o = o + 1e-9 * cr._sweep_ts(o, d, p_mat, t_min).amin(dim=0, keepdim=True)
    return count


def work(name: str, args: tuple, reps: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one launch of probe `name` on `args`:
    the operations its arithmetic needs on these inputs, and each input
    read once and each output written once."""
    if name == "chain_fma":
        (x,) = args
        return 2.0 * x.numel() * reps, 2.0 * 4 * x.numel()
    if name == "fma_peak":
        (x,) = args
        cols = x.shape[1]
        return (2.0 * FMA_ACCS * 8 * cols * reps * FMA_UNROLL + 2.0 * FMA_ACCS * 8 * cols,
                4.0 * (64 + 8) * cols)
    if name == "sweep_probe":
        table, o, _ = args
        n, cols = table.shape[0], o.shape[1]
        roots = real_roots(*args, reps)
        # Per lane and rep: o.d and o.o (10), the sphere tests, o += s and
        # acc += t (5).
        ops = reps * cols * (OPS_PER_SPHERE_TEST * n + 15.0) + OPS_PER_REAL_ROOT * roots
        return ops, 4.0 * (16 * n + 6 * cols + cols)
    if name == "gather_probe":
        p, oh = args
        n, cols = oh.shape
        return reps * cols * (2.0 * 16 * n + 2.0 * n + 2.0), 4.0 * (16 * n + n * cols + cols)
    if name == "skinny_probe":
        l, r = args
        m, cols = l.shape[0], r.shape[1]
        return reps * cols * (15.0 * m + 8.0 + 2.0), 4.0 * (8 * m + 8 * cols + cols)
    raise ValueError(f"unknown probe {name!r}")


def bound_ms(ops: float, n_bytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    3.35 TB/s and the float32 operations over 67 TFLOP/s."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Measurement on the card.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Timing:
    name: str
    tile: int
    reps: int
    ms: float  # one launch, CUDA events
    ops: float
    n_bytes: float
    bound_ms: float
    bound_by: str
    library_ms: float | None = None  # `reps` torch.matmul of the same product, TF32 off
    library_tf32_ms: float | None = None  # the same with TF32 on (the skinny product)

    @property
    def rate(self) -> float:
        return self.ops / (self.ms * 1e-3)

    @property
    def us_per_tile_iter(self) -> float:
        """Microseconds per rep of 2048 columns (the script's grid step)."""
        return self.ms * 1e3 / (self.reps * self.tile / JAX_TILE)

    def line(self) -> str:
        s = (f"{self.name} tile {self.tile} reps {self.reps}: {self.ms:.4f} ms "
             f"{self.rate / 1e12:.2f} TFLOP/s ({self.us_per_tile_iter:.3f} us per 2048-column rep); "
             f"bound {self.bound_ms:.4f} ms by {self.bound_by} ({100 * self.bound_ms / self.ms:.1f}% "
             f"of bound)")
        if self.library_ms is not None:
            s += f"; torch.matmul x{self.reps}: {self.library_ms:.4f} ms"
        if self.library_tf32_ms is not None:
            s += f", with TF32 {self.library_tf32_ms:.4f} ms"
        return s


def _matmul_ms(a, b, reps, tf32):
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        torch.matmul(a, b)
        return cuda_ms(lambda: torch.matmul(a, b), reps=max(reps, 8)) * reps
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def time_part(name: str, tile: int, reps: int, device, launches: int = 5) -> Timing:
    """Time probe `name` at `tile` columns on the card: the mean of
    `launches` launches after one warm-up, by CUDA events."""
    from ray_tracing_in_one_weekend_tpu_torch.probes import cuda_ms

    args = inputs(name, tile, device)
    run(name, args, reps)
    ms = cuda_ms(lambda: run(name, args, reps), reps=launches)
    ops, n_bytes = work(name, args, reps)
    t = Timing(name, tile, reps, ms, ops, n_bytes, *bound_ms(ops, n_bytes))
    if name == "gather_probe":
        t.library_ms = _matmul_ms(args[0], args[1], reps, tf32=False)
    if name == "skinny_probe":
        t.library_ms = _matmul_ms(args[0], args[1], reps, tf32=False)
        t.library_tf32_ms = _matmul_ms(args[0], args[1], reps, tf32=True)
    return t


def main(argv=None) -> dict:
    """Time every part at `tile` and at FILL_TILE columns; prints one line
    per part and shape and returns {name: [Timing at tile, at FILL_TILE]}."""
    argv = sys.argv[1:] if argv is None else argv
    tile = int(argv[0]) if len(argv) > 0 else JAX_TILE
    reps = int(argv[1]) if len(argv) > 1 else 64
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_parts measures the card: it needs a CUDA GPU")
    from ray_tracing_in_one_weekend_tpu_torch.probes import nvidia_smi

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    out = {}
    for name in PARTS:
        out[name] = [time_part(name, t, reps, dev) for t in (tile, FILL_TILE)]
        for t in out[name]:
            print(f"{t.line()} [{smi}]", flush=True)
    return out


if __name__ == "__main__":
    main()
