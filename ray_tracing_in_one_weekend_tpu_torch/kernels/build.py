"""Build the CUDA kernels of `csrc/` and bind them to PyTorch with ctypes.

The sources are compiled with nvcc into one shared library with a plain C
interface under `build/kernels/` at the repo root, at first use, and
again whenever a hash of the sources and flags changes (the hash names
the library). Each `.cu` file is compiled by its own nvcc, all started
together, and the objects are linked into the library. No PyTorch header
is compiled, so a build takes seconds.

`render_pass` is the wrapper of `csrc/render_kernel.cu`;
`threefry_render` that of `csrc/threefry_render_kernel.cu` (the jnp
backend's forward on threefry keys); `threefry_replay` and
`threefry_reverse` (chained with `grad_reduce` in `threefry_grad_pass`)
those of the keyed backward's two kernels, `csrc/threefry_grad_kernel.cu`;
`grad_replay`,
`grad_reverse` and `grad_reduce` (chained in `grad_pass`) are those of the
three kernels of `csrc/grad_kernel.cu`, the backward's replay, its reverse
walk and its reduction; `chain_fma`,
`fma_peak`, `sweep_probe`, `gather_probe`, `skinny_probe` and
`skinny_default_probe` are those of the six probe kernels of
`csrc/probe_kernels.cu`. Each checks its
tensors, allocates the outputs, launches on PyTorch's current stream,
raises if the launch failed, and counts its launches in `LAUNCHES`.
`blocks_per_sm` reads the occupancy of the kernels that sweep the scene,
and of the reduction's chunk kernel, from the CUDA runtime;
`threefry_grid` the persistent grid of the keyed kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

# No --use_fast_math: the sweep relies on IEEE NaN compares, and the
# transcendentals stay at full precision (csrc/render_device.cuh).
# -fmad=false: no a*b+c contraction, so the kernel rounds every operation
# as the plain PyTorch version does and the two agree bit for bit on the
# card. Contraction was measured on an H100 80GB HBM3 (700 W) by
# `python -m ray_tracing_in_one_weekend_tpu_torch.probes.fma_contraction`:
# 9% faster (20.9 vs 22.8 ms per bench pass) but 3.8% of lanes diverged
# from the plain version at 64x32, spp 4 — bounces off small spheres
# amplify a last-ulp difference into a different path.
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

# Launches per kernel since the last `reset_launches()`: what a run reads
# to show that its main path went through the kernels.
LAUNCHES = {
    "render_kernel": 0, "threefry_render_kernel": 0, "threefry_replay": 0, "threefry_reverse": 0,
    "grad_replay": 0, "grad_reverse": 0, "grad_reduce": 0, "bounce_adjoint": 0,
    "chain_fma": 0, "fma_peak": 0, "sweep_probe": 0, "gather_probe": 0, "skinny_probe": 0,
    "skinny_probe_default": 0,
}

_LIB = None
# The product probes hold one operand in registers, split over 8 warps
# (csrc/probe_kernels.cu): the gather 8 k-slabs of P a warp, the skinny
# product 8 m16 tiles of L a warp.
_GATHER_MAX_N = 512
_SKINNY_MAX_M = 1024


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library for these sources already existed
    log: str  # nvcc's output, with ptxas' register, spill and shared-memory report


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: cannot build csrc/")


def _run_all(cmds) -> str:
    """Run the commands side by side; raise if any fails, else return their
    output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> BuildResult:
    """Compile `csrc/*.cu` unless the library for these sources exists. The
    log is kept beside the library and returned with it."""
    lib = BUILD_DIR / f"librt_kernels_{source_hash()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return BuildResult(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{lib.stem}.{os.getpid()}"
    units = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{stem}.{p.stem}.o" for p in units]
    tmp = lib.with_name(f"{stem}.tmp.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(p), "-o", str(o)]
                        for p, o in zip(units, objs)])
        log += _run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return BuildResult(lib, seconds, log)


def load() -> ctypes.CDLL:
    """Build if needed, then load and bind the library (once per process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rt_render_pass.restype = i32
        lib.rt_render_pass.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, ptr,  # table, n_spheres, cam, sf, si, of, oi
            i32, i32, i32, i32, i32, i32, i32,  # n_lanes, tile, seed, sample_offset, budget, spp, max_depth
            ptr,  # stream
        ]
        # Each kernel's largest scene (its shared-memory sweep table, or the
        # reduction's accumulators), the reduction's walk, and each kernel's
        # resident blocks an SM.
        for name in ("rt_max_tile", "rt_render_max_spheres", "rt_replay_max_spheres",
                     "rt_sweep_probe_max_spheres", "rt_reduce_max_spheres", "rt_reduce_stage_events",
                     "rt_reduce_warps", "rt_reduce_fold_round"):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = []
        for name, args in (("rt_render_blocks_per_sm", [i32, i32]), ("rt_replay_blocks_per_sm", [i32, i32]),
                           ("rt_sweep_probe_blocks_per_sm", [i32]), ("rt_reduce_blocks_per_sm", [i32])):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = args
        lib.rt_threefry_render.restype = i32
        lib.rt_threefry_render.argtypes = [
            ptr, i32, ptr, ptr, i32,  # table, n_spheres, cam, pix, n
            ctypes.c_uint, ctypes.c_uint, i32, i32, i32,  # key0, key1, sample_offset, spp, max_depth
            ptr, ptr, ptr, ptr,  # out, work, queue, stream
        ]
        for name in ("rt_threefry_max_spheres", "rt_threefry_block"):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = []
        lib.rt_threefry_blocks_per_sm.restype = i32
        lib.rt_threefry_blocks_per_sm.argtypes = [i32]
        lib.rt_threefry_grid.restype = i32
        lib.rt_threefry_grid.argtypes = [i32, i32]
        lib.rt_threefry_replay_blocks_per_sm.restype = i32
        lib.rt_threefry_replay_blocks_per_sm.argtypes = [i32]
        lib.rt_threefry_replay.restype = i32
        lib.rt_threefry_replay.argtypes = [
            ptr, i32, ptr, ptr, i32,  # table, n_spheres, cam, pix, n
            ctypes.c_uint, ctypes.c_uint, i32, i32, i32,  # key0, key1, sample_offset, spp, max_depth
            ptr, ptr, ptr, ptr, ptr, ptr,  # ev_start, ev_count, records, flags, queue, stream
        ]
        lib.rt_threefry_reverse.restype = i32
        lib.rt_threefry_reverse.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # table, cam, g, ev_start, ev_count, records
            ctypes.c_longlong, i32, ptr,  # n_records, n, stream
        ]
        lib.rt_grad_replay.restype = i32
        lib.rt_grad_replay.argtypes = [
            ptr, i32, ptr, ptr,  # table, n_spheres, cam, pix
            ptr, ptr, ptr, ptr,  # ev_start, ev_count, records, flags
            i32, i32, i32, i32, i32, i32, i32,  # n_lanes, tile, n_live, seed, sample_offset, spp, max_depth
            ptr,  # stream
        ]
        lib.rt_grad_reverse.restype = i32
        lib.rt_grad_reverse.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # table, cam, g, ev_start, ev_count, records
            ctypes.c_longlong, i32, i32, ptr,  # n_records, n_lanes, tile, stream
        ]
        lib.rt_grad_reduce.restype = i32
        lib.rt_grad_reduce.argtypes = [ptr, ctypes.c_longlong, i32, ptr, ptr, ptr]
        lib.rt_bounce_adjoint.restype = i32
        lib.rt_bounce_adjoint.argtypes = [ptr, ctypes.c_float, i32, *([ptr] * 12)]
        lib.rt_max_grad_tile.restype = i32
        lib.rt_max_grad_tile.argtypes = []
        lib.rt_chunk_events.restype = ctypes.c_longlong
        lib.rt_chunk_events.argtypes = []
        i64, f32 = ctypes.c_longlong, ctypes.c_float
        for name, args in (
            ("rt_chain_fma", [ptr, ptr, i64, i32, ptr]),
            ("rt_fma_peak", [ptr, ptr, i32, i32, ptr]),
            ("rt_sweep_probe", [ptr, i32, ptr, ptr, ptr, i32, i32, f32, ptr]),
            ("rt_gather_probe", [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]),
            ("rt_skinny_probe", [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]),
            ("rt_skinny_default_probe", [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]),
        ):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = args
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_error_string.argtypes = [i32]
        _LIB = lib
    return _LIB


def _check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _check_int32(name, v):
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"{name} ({v}) does not fit in int32")


def _check_spheres(n_spheres, most):
    """`most`: the kernel's largest scene, as its library reports it."""
    if not 0 < n_spheres <= most:
        raise ValueError(f"{n_spheres} spheres do not fit the kernel's shared-memory sweep table "
                         f"(at most {most})")


def blocks_per_sm(kernel: str, tile: int, n_spheres: int) -> int:
    """Resident blocks an SM holds of `kernel` ("render_kernel",
    "grad_replay", "sweep_probe", or "threefry_render_kernel" and
    "threefry_replay_kernel", whose block is always 128 threads, or
    "grad_reduce_chunks", always 256) at `tile` threads a block for a scene
    of `n_spheres`: the CUDA runtime's occupancy from the kernel's
    registers and shared memory."""
    lib = load()
    if kernel == "sweep_probe":
        n = lib.rt_sweep_probe_blocks_per_sm(n_spheres)
    elif kernel == "threefry_render_kernel":
        n = lib.rt_threefry_blocks_per_sm(n_spheres)
    elif kernel == "threefry_replay_kernel":
        n = lib.rt_threefry_replay_blocks_per_sm(n_spheres)
    elif kernel == "grad_reduce_chunks":
        n = lib.rt_reduce_blocks_per_sm(n_spheres)
    else:
        fn = {"render_kernel": lib.rt_render_blocks_per_sm, "grad_replay": lib.rt_replay_blocks_per_sm}[kernel]
        n = fn(tile, n_spheres)
    if n < 0:
        _raise_on(lib, -n, f"{kernel} occupancy")
    return n


def threefry_grid(n_spheres: int, n: int, device=None) -> int:
    """Blocks of `threefry_render_kernel`'s persistent grid for `n` pixels
    of a scene of `n_spheres` on `device`: SMs x resident blocks, at most
    one block a 128 pixels."""
    lib = load()
    with torch.cuda.device(device):
        g = lib.rt_threefry_grid(n_spheres, n)
    if g < 0:
        _raise_on(lib, -g, "threefry_render_kernel grid")
    return g


def render_pass(table, cam_vec, scalars, sf, si, tile, spp, max_depth):
    """One pass of `csrc/render_kernel.cu` on CUDA tensors -> (of, oi).

    table [N, 16] f32 (the transposed packed scene), cam_vec [24] f32,
    sf [16, P] f32, si [8, P] i32, all contiguous on one CUDA device;
    scalars = (seed, pixel_offset, sample_offset, budget) ints. `tile`
    lanes per block: a multiple of 128, at most the kernel's MAX_TILE,
    dividing P."""
    device = sf.device
    if device.type != "cuda":
        raise ValueError(f"render_pass runs on CUDA tensors, got {device}")
    n_lanes = sf.shape[1] if sf.dim() == 2 else -1
    n_spheres = table.shape[0] if table.dim() == 2 else -1
    _check_tensor("table", table, torch.float32, (n_spheres, 16), device)
    _check_tensor("cam_vec", cam_vec, torch.float32, (24,), device)
    _check_tensor("sf", sf, torch.float32, (16, n_lanes), device)
    _check_tensor("si", si, torch.int32, (8, n_lanes), device)
    lib = load()
    _check_spheres(n_spheres, lib.rt_render_max_spheres())
    max_tile = lib.rt_max_tile()
    if tile <= 0 or tile % 128 or tile > max_tile:
        raise ValueError(f"tile ({tile}) must be a multiple of 128 no larger than {max_tile}")
    if n_lanes <= 0 or n_lanes % tile:
        raise ValueError(f"lane count ({n_lanes}) must be a positive multiple of tile ({tile})")
    seed, _pixel_offset, sample_offset, budget = (int(v) for v in scalars)
    for name, v in (("seed", seed), ("sample_offset", sample_offset), ("budget", budget),
                    ("spp", spp), ("max_depth", max_depth)):
        _check_int32(name, v)

    of = torch.empty_like(sf)
    oi = torch.empty_like(si)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_render_pass(
            table.data_ptr(), n_spheres, cam_vec.data_ptr(), sf.data_ptr(), si.data_ptr(),
            of.data_ptr(), oi.data_ptr(), n_lanes, tile, seed, sample_offset, budget,
            int(spp), int(max_depth), stream,
        )
    _raise_on(lib, err, "render_kernel")
    LAUNCHES["render_kernel"] += 1
    return of, oi


def threefry_render(table, cam_vec, pix, key, sample_offset, spp, max_depth, work=False):
    """`csrc/threefry_render_kernel.cu` on CUDA tensors -> [n, 3] float32
    radiance means (and, with `work`, the [n] int32 sweeps a pixel).

    table [N, 16] f32 (the transposed packed scene), cam_vec [24] f32, pix
    [n] i32 global pixel ids, all contiguous on one CUDA device; `key` the
    base key's two uint32 words; samples [sample_offset, sample_offset +
    spp) of each pixel, up to `max_depth` bounces each. The kernel's
    persistent grid (`threefry_grid`) takes the positions past its threads
    from a queue counter, allocated and zeroed here for every launch."""
    device = pix.device
    n, n_spheres, k0, k1 = _check_keyed(table, cam_vec, pix, key, sample_offset, spp, max_depth, device,
                                        "threefry_render")
    lib = load()
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    counts = torch.empty((n,), dtype=torch.int32, device=device) if work else None
    if n == 0:
        return (out, counts) if work else out
    queue = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_threefry_render(
            table.data_ptr(), n_spheres, cam_vec.data_ptr(), pix.data_ptr(), n, k0, k1,
            int(sample_offset), int(spp), int(max_depth), out.data_ptr(),
            counts.data_ptr() if work else None, queue.data_ptr(), stream,
        )
    _raise_on(lib, err, "threefry_render_kernel")
    LAUNCHES["threefry_render_kernel"] += 1
    return (out, counts) if work else out


def _check_keyed(table, cam_vec, pix, key, sample_offset, spp, max_depth, device, name):
    """The keyed kernels' common checks -> (n, n_spheres, k0, k1)."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {device}")
    n = pix.shape[0] if pix.dim() == 1 else -1
    n_spheres = table.shape[0] if table.dim() == 2 else -1
    _check_tensor("table", table, torch.float32, (n_spheres, 16), device)
    _check_tensor("cam_vec", cam_vec, torch.float32, (24,), device)
    _check_tensor("pix", pix, torch.int32, (n,), device)
    _check_spheres(n_spheres, load().rt_threefry_max_spheres())
    k0, k1 = (int(w) for w in key)
    for label, v in (("key[0]", k0), ("key[1]", k1)):
        if not 0 <= v < 1 << 32:
            raise ValueError(f"{label} ({v}) is not a uint32 word")
    if spp < 1 or max_depth < 1:
        raise ValueError(f"spp ({spp}) and max_depth ({max_depth}) must be >= 1")
    for label, v in (("sample_offset", sample_offset), ("spp", spp), ("max_depth", max_depth),
                     ("sample_offset + spp", sample_offset + spp)):
        _check_int32(label, int(v))
    return n, n_spheres, k0, k1


@dataclasses.dataclass
class Replay:
    """The replay's records and each lane's slots: lane i owns records
    [ev_start[i], ev_start[i] + ev_count[i]). `grad_reverse` consumes it:
    it turns the records into events in place and sets `records` to None,
    so no Replay is reversed twice."""

    records: torch.Tensor | None  # [E, 16] f32, one per bounce; None once reversed
    ev_start: torch.Tensor  # [P] int64
    ev_count: torch.Tensor  # [P] int32


def event_slots(pix, work, pixel_offset, n_live):
    """Each lane's record slots -> (ev_start [P] int64, ev_count [P] int32).

    A lane owns as many slots as its pixel's bounce count (`work`
    [n_live - pixel_offset], the forward's count in pixel order), and the
    ranges follow the lanes' pixel ids in increasing order (an exclusive
    prefix sum), so the records, and the reduction over their events, do
    not depend on the lane order or the tile. Pad lanes (ids outside
    [pixel_offset, n_live)) own none."""
    local = pix.to(torch.int64) - pixel_offset
    live = (local >= 0) & (pix < n_live)
    counts = torch.where(live, work.to(torch.int64)[torch.where(live, local, 0)], 0)
    order = torch.argsort(torch.where(live, local, 1 << 40), stable=True)
    ev_start = torch.empty_like(counts)
    ev_start[order] = torch.cumsum(counts[order], 0) - counts[order]
    return ev_start, counts.to(torch.int32)


def _check_grad_tables(table, cam_vec, device):
    n_spheres = table.shape[0] if table.dim() == 2 else -1
    _check_tensor("table", table, torch.float32, (n_spheres, 16), device)
    _check_tensor("cam_vec", cam_vec, torch.float32, (24,), device)
    return n_spheres


def _check_grad_tile(lib, tile, n_lanes):
    max_tile = lib.rt_max_grad_tile()
    if tile <= 0 or tile % 128 or tile > max_tile:
        raise ValueError(f"tile ({tile}) must be a multiple of 128 no larger than {max_tile}")
    if n_lanes <= 0 or n_lanes % tile:
        raise ValueError(f"lane count ({n_lanes}) must be a positive multiple of tile ({tile})")


def grad_pass(table, cam_vec, scalars, pix, g, work, tile, spp, max_depth):
    """The backward of `csrc/grad_kernel.cu` on CUDA tensors -> [16, N]
    f32, the cotangent of the packed scene: `grad_replay`, `grad_reverse`
    on its records, then `grad_reduce` over the events."""
    replay = grad_replay(table, cam_vec, scalars, pix, work, tile, spp, max_depth)
    return grad_reduce(grad_reverse(table, cam_vec, replay, g, tile), table.shape[0])


def grad_replay(table, cam_vec, scalars, pix, work, tile, spp, max_depth) -> Replay:
    """`grad_replay_kernel` on CUDA tensors: every lane's paths replayed
    with the forward's persistent-sample loop -> `Replay`, one 64-byte
    record per bounce in the lane's slots (`event_slots`), in sample and
    bounce order. Record words (int fields as int32 bits): 0-2 the
    pre-bounce o, 3-5 d, 6-8 att, 9 the winning sphere (-1 for a miss),
    10-11 the stream words, 12 the depth, 13 how the path goes on (0 on,
    1 ends without radiance, 2 ends at the sky), 14-15 zero.

    table [N, 16] f32 (the transposed packed scene), cam_vec [24] f32, pix
    [P] i32 (each lane's global pixel id, in any order; ids >= n_live
    idle), work [n_live - pixel_offset] f32 (the forward's per-pixel
    bounce count in pixel order), all contiguous on one CUDA device;
    scalars = (seed, pixel_offset, sample_offset, n_live) ints. `tile`
    lanes per block: a multiple of 128, at most the kernel's maximum,
    dividing P. Raises if the replay did not take the forward's path (a
    lane's bounce count differs from `work`): nothing is truncated."""
    device = pix.device
    if device.type != "cuda":
        raise ValueError(f"grad_replay runs on CUDA tensors, got {device}")
    n_lanes = pix.shape[0] if pix.dim() == 1 else -1
    seed, pixel_offset, sample_offset, n_live = (int(v) for v in scalars)
    n_spheres = _check_grad_tables(table, cam_vec, device)
    _check_tensor("pix", pix, torch.int32, (n_lanes,), device)
    _check_tensor("work", work, torch.float32, (n_live - pixel_offset,), device)
    lib = load()
    _check_spheres(n_spheres, lib.rt_replay_max_spheres())
    _check_grad_tile(lib, tile, n_lanes)
    if not 0 <= pixel_offset < n_live:
        raise ValueError(f"pixel range [{pixel_offset}, {n_live}) is empty")
    if spp < 1 or max_depth < 1:
        raise ValueError(f"spp ({spp}) and max_depth ({max_depth}) must be >= 1")
    for name, v in (("seed", seed), ("sample_offset", sample_offset), ("n_live", n_live),
                    ("spp", spp), ("max_depth", max_depth)):
        _check_int32(name, v)
    if not torch.equal(work.round(), work):
        raise ValueError("work must hold whole bounce counts")

    ev_start, ev_count = event_slots(pix, work, pixel_offset, n_live)
    records = torch.empty((int(ev_count.sum()), 16), dtype=torch.float32, device=device)
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_grad_replay(
            table.data_ptr(), n_spheres, cam_vec.data_ptr(), pix.data_ptr(), ev_start.data_ptr(),
            ev_count.data_ptr(), records.data_ptr(), flags.data_ptr(), n_lanes, tile, n_live, seed,
            sample_offset, int(spp), int(max_depth), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "grad_replay_kernel")
    LAUNCHES["grad_replay"] += 1
    over, under = flags.tolist()
    if over or under:
        raise RuntimeError(
            "grad_replay_kernel: the replay diverged from the forward render (a lane had "
            f"{'more' if over else 'fewer'} bounces than its pixel's work count)"
        )
    return Replay(records, ev_start, ev_count)


def grad_reverse(table, cam_vec, replay: Replay, g, tile):
    """`grad_reverse_kernel` on CUDA tensors: each lane walks its records
    from the last to the first and overwrites each IN PLACE with that
    bounce's event -> the record buffer, now events [E, 16] f32: word 0 the
    winning sphere as int32 bits (-1 for none: a miss, or a path that ends
    without radiance), words 1-13 the cotangent of its rows 0-3, 5-9,
    12-15, words 14-15 zero.

    `replay` as `grad_replay` returned it, with the same table and cam_vec;
    the call consumes it (`replay.records` becomes None). g [3, P] f32,
    each lane's radiance cotangent per sample; `tile` as for
    `grad_replay`. A lane whose slot range does not lie inside the records
    writes nothing."""
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"grad_reverse runs on CUDA tensors, got {device}")
    records, ev_start, ev_count = replay.records, replay.ev_start, replay.ev_count
    if records is None:
        raise ValueError("grad_reverse: this Replay was reversed already (its records are events now)")
    n_lanes = g.shape[1] if g.dim() == 2 else -1
    _check_grad_tables(table, cam_vec, device)
    _check_tensor("g", g, torch.float32, (3, n_lanes), device)
    _check_tensor("ev_start", ev_start, torch.int64, (n_lanes,), device)
    _check_tensor("ev_count", ev_count, torch.int32, (n_lanes,), device)
    n_events = records.shape[0] if records.dim() == 2 else -1
    _check_tensor("records", records, torch.float32, (n_events, 16), device)
    lib = load()
    _check_grad_tile(lib, tile, n_lanes)
    replay.records = None
    with torch.cuda.device(device):
        err = lib.rt_grad_reverse(
            table.data_ptr(), cam_vec.data_ptr(), g.data_ptr(), ev_start.data_ptr(), ev_count.data_ptr(),
            records.data_ptr(), n_events, n_lanes, tile, torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "grad_reverse_kernel")
    LAUNCHES["grad_reverse"] += 1
    return records


def grad_reduce(events, n_spheres):
    """The fixed-order reduction of `csrc/grad_kernel.cu` on CUDA tensors:
    events [E, 16] f32 from `grad_reverse` -> [16, n_spheres] f32, each
    sphere's cotangent summed over its events in the order of
    `ops/cuda_grad.py::_reduce_events_ordered` (chunks of `rt_chunk_events()`
    events, each sphere's events in index order from +0, then the chunks in
    order), so the same events give the same bits, run after run. Winners
    outside [0, n_spheres) add nothing; rows 4, 10 and 11 are +0."""
    device = events.device
    if device.type != "cuda":
        raise ValueError(f"grad_reduce runs on CUDA tensors, got {device}")
    n_events = events.shape[0] if events.dim() == 2 else -1
    _check_tensor("events", events, torch.float32, (n_events, 16), device)
    lib = load()
    most = lib.rt_reduce_max_spheres()
    if not 0 < n_spheres <= most:
        raise ValueError(f"{n_spheres} spheres: the reduction takes at most {most}")
    n_chunks = -(-n_events // lib.rt_chunk_events())
    partials = torch.empty((max(n_chunks, 1), 13, n_spheres), dtype=torch.float32, device=device)
    out = torch.empty((16, n_spheres), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_grad_reduce(events.data_ptr(), n_events, n_spheres, partials.data_ptr(),
                                 out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "grad_reduce")
    LAUNCHES["grad_reduce"] += 1
    return out


def threefry_grad_pass(table, cam_vec, pix, key, sample_offset, spp, max_depth, work, pixel_offset, n_live, g):
    """The keyed backward on CUDA tensors -> [16, N] f32, the cotangent of
    the packed scene: `threefry_replay`, `threefry_reverse` on its records,
    then `grad_reduce` over the events."""
    replay = threefry_replay(table, cam_vec, pix, key, sample_offset, spp, max_depth, work, pixel_offset, n_live)
    return grad_reduce(threefry_reverse(table, cam_vec, replay, g), table.shape[0])


def threefry_replay(table, cam_vec, pix, key, sample_offset, spp, max_depth, work, pixel_offset, n_live) -> Replay:
    """`threefry_replay_kernel` on CUDA tensors: the keyed forward's paths of
    global pixel ids `pix` [n] i32, replayed with its persistent loop and
    pixel queue -> `Replay`, one 64-byte record a sweep in the position's
    slots (`event_slots`: the ranges follow the pixel ids in increasing
    order), in sample and bounce order. Record words (int fields as int32
    bits): 0-2 the pre-bounce o, 3-5 d, 6-8 att, 9 the winning sphere (-1
    for a miss), 10-11 the sample's trace key, 12 the bounce index, 13 how
    the path goes on (0 on, 1 ends without radiance, 2 ends at the sky),
    14-15 zero.

    table, cam_vec, key, sample_offset, spp and max_depth as for
    `threefry_render`; `work` [n_live - pixel_offset] int, the forward's
    sweeps of each pixel in pixel order (its `work` output); every id of
    `pix` must lie in [pixel_offset, n_live). Raises if the replay did not
    take the forward's paths (a pixel's sweeps differ from `work`)."""
    device = pix.device
    n, n_spheres, k0, k1 = _check_keyed(table, cam_vec, pix, key, sample_offset, spp, max_depth, device,
                                        "threefry_replay")
    pixel_offset, n_live = int(pixel_offset), int(n_live)
    if work.device != device or work.dtype not in (torch.int32, torch.int64) \
            or tuple(work.shape) != (n_live - pixel_offset,):
        raise ValueError(f"work must be an integer tensor [{n_live - pixel_offset}] on {device}, got "
                         f"{work.dtype} {tuple(work.shape)} on {work.device}")
    if n > 0 and not (int(pix.min()) >= pixel_offset and int(pix.max()) < n_live):
        raise ValueError(f"pixel ids must lie in [{pixel_offset}, {n_live})")
    lib = load()
    ev_start, ev_count = event_slots(pix, work, pixel_offset, n_live)
    records = torch.empty((int(ev_count.sum()), 16), dtype=torch.float32, device=device)
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    queue = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_threefry_replay(
            table.data_ptr(), n_spheres, cam_vec.data_ptr(), pix.data_ptr(), n, k0, k1, int(sample_offset),
            int(spp), int(max_depth), ev_start.data_ptr(), ev_count.data_ptr(), records.data_ptr(),
            flags.data_ptr(), queue.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "threefry_replay_kernel")
    LAUNCHES["threefry_replay"] += 1
    over, under = flags.tolist()
    if over or under:
        raise RuntimeError(
            "threefry_replay_kernel: the replay diverged from the forward render (a pixel had "
            f"{'more' if over else 'fewer'} sweeps than its work count)"
        )
    return Replay(records, ev_start, ev_count)


def threefry_reverse(table, cam_vec, replay: Replay, g):
    """`threefry_reverse_kernel` on CUDA tensors: each position walks its
    records from the last to the first and overwrites each IN PLACE with
    that bounce's event -> the record buffer, now events [E, 16] f32 in
    `grad_reverse`'s layout: word 0 the winning sphere as int32 bits (-1 for
    none), words 1-13 the cotangent of its rows 0-3, 5-9, 12-15 (rows 12-15
    zero: the keyed sweep reads center and radius), words 14-15 zero.

    `replay` as `threefry_replay` returned it, with the same table and
    cam_vec; the call consumes it (`replay.records` becomes None). g [3, n]
    f32, each position's radiance cotangent of one sample."""
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"threefry_reverse runs on CUDA tensors, got {device}")
    records, ev_start, ev_count = replay.records, replay.ev_start, replay.ev_count
    if records is None:
        raise ValueError("threefry_reverse: this Replay was reversed already (its records are events now)")
    n = g.shape[1] if g.dim() == 2 else -1
    _check_grad_tables(table, cam_vec, device)
    _check_tensor("g", g, torch.float32, (3, n), device)
    _check_tensor("ev_start", ev_start, torch.int64, (n,), device)
    _check_tensor("ev_count", ev_count, torch.int32, (n,), device)
    n_events = records.shape[0] if records.dim() == 2 else -1
    _check_tensor("records", records, torch.float32, (n_events, 16), device)
    lib = load()
    replay.records = None
    with torch.cuda.device(device):
        err = lib.rt_threefry_reverse(
            table.data_ptr(), cam_vec.data_ptr(), g.data_ptr(), ev_start.data_ptr(), ev_count.data_ptr(),
            records.data_ptr(), n_events, n, torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "threefry_reverse_kernel")
    LAUNCHES["threefry_reverse"] += 1
    return records


def bounce_adjoint(table, t_min, rec, ob, db, ab):
    """The hand-written adjoint of `csrc/grad_device.cuh` on recorded
    bounces that continue: the checks' way to hold it against autograd.

    `rec` maps o, d, att ([3, n] f32), winner, lo, hi, depth ([n] i32:
    the winning sphere, the stream words as int32 bits, the bounce depth);
    ob, db, ab [3, n] f32 are the cotangents of the bounce's outputs.
    Returns the cotangents of its inputs (ob, db, ab) and of the winner's
    parameter column, pbar [16, n]."""
    device = ob.device
    if device.type != "cuda":
        raise ValueError(f"bounce_adjoint runs on CUDA tensors, got {device}")
    n = ob.shape[1] if ob.dim() == 2 else -1
    n_spheres = table.shape[0] if table.dim() == 2 else -1
    _check_tensor("table", table, torch.float32, (n_spheres, 16), device)
    for name in ("o", "d", "att"):
        _check_tensor(name, rec[name], torch.float32, (3, n), device)
    for name in ("winner", "lo", "hi", "depth"):
        _check_tensor(name, rec[name], torch.int32, (n,), device)
    ob, db, ab = (x.clone().contiguous() for x in (ob, db, ab))
    for name, x in (("ob", ob), ("db", db), ("ab", ab)):
        _check_tensor(name, x, torch.float32, (3, n), device)
    if n <= 0 or int(rec["winner"].min()) < 0 or int(rec["winner"].max()) >= n_spheres:
        raise ValueError("winner indices must name spheres of the table")
    lib = load()
    pbar = torch.empty((16, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_bounce_adjoint(
            table.data_ptr(), float(t_min), n,
            *(rec[k].data_ptr() for k in ("o", "d", "att", "winner", "lo", "hi", "depth")),
            ob.data_ptr(), db.data_ptr(), ab.data_ptr(), pbar.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "bounce_adjoint")
    LAUNCHES["bounce_adjoint"] += 1
    return ob, db, ab, pbar


# ---------------------------------------------------------------------------
# The probe kernels (csrc/probe_kernels.cu). Their plain versions are in
# probes/kernel_parts.py.
# ---------------------------------------------------------------------------


def _cuda_only(name, t):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name} runs on CUDA tensors, got {where}")
    return t.device


def _check_reps(reps):
    if not 1 <= reps < (1 << 31):
        raise ValueError(f"reps ({reps}) must be a positive int32")


def _launch(name, fn, device, *args):
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1


def chain_fma(x, chain):
    """`chain_fma_kernel`: x [R, tile] f32 -> [R, tile], one dependent chain
    of `chain` fused steps acc = fma(acc, 1.0000001, 1e-7) per element."""
    device = _cuda_only("chain_fma", x)
    rows, tile = x.shape if x.dim() == 2 else (-1, -1)
    _check_tensor("x", x, torch.float32, (rows, tile), device)
    _check_reps(chain)
    out = torch.empty_like(x)
    _launch("chain_fma", "rt_chain_fma", device, x.data_ptr(), out.data_ptr(), x.numel(), int(chain))
    return out


def fma_peak(x, reps):
    """`fma_peak_kernel`: x [64, tile] f32 -> [8, tile], eight independent
    accumulators x[8i:8i+8] + i, each `reps` x 16 fused steps, summed."""
    device = _cuda_only("fma_peak", x)
    tile = x.shape[1] if x.dim() == 2 else -1
    _check_tensor("x", x, torch.float32, (64, tile), device)
    _check_reps(reps)
    _check_int32("8 * tile", 8 * tile)
    out = torch.empty((8, tile), dtype=torch.float32, device=device)
    _launch("fma_peak", "rt_fma_peak", device, x.data_ptr(), out.data_ptr(), tile, int(reps))
    return out


def sweep_probe(table, o, d, reps, t_min):
    """`sweep_probe_kernel`: table [N, 16] f32 (the transposed packed scene),
    o, d [3, tile] f32 (d unit) -> [1, tile], the sum over `reps` of the
    closest hit's t, with o += 1e-9 t after each rep."""
    device = _cuda_only("sweep_probe", o)
    tile = o.shape[1] if o.dim() == 2 else -1
    n_spheres = table.shape[0] if table.dim() == 2 else -1
    _check_tensor("table", table, torch.float32, (n_spheres, 16), device)
    _check_tensor("o", o, torch.float32, (3, tile), device)
    _check_tensor("d", d, torch.float32, (3, tile), device)
    _check_spheres(n_spheres, load().rt_sweep_probe_max_spheres())
    _check_reps(reps)
    out = torch.empty((1, tile), dtype=torch.float32, device=device)
    _launch("sweep_probe", "rt_sweep_probe", device, table.data_ptr(), n_spheres, o.data_ptr(),
            d.data_ptr(), out.data_ptr(), tile, int(reps), float(t_min))
    return out


def gather_probe(p, oh, reps):
    """`gather_probe_kernel`: P [16, N] f32, OH [N, tile] f32 -> [1, tile],
    the sum over `reps` of row 0 of P @ OH (3xTF32 on the tensor cores:
    float32 accuracy), with OH += 1e-12 row 0 after each rep. OH is not
    written: each block updates its slice in shared memory. The product's
    other rows go to a discarded per-column checksum, which keeps them
    computed."""
    device = _cuda_only("gather_probe", oh)
    n, tile = oh.shape if oh.dim() == 2 else (-1, -1)
    _check_tensor("p", p, torch.float32, (16, n), device)
    _check_tensor("oh", oh, torch.float32, (n, tile), device)
    if not (0 < n <= _GATHER_MAX_N and n % 8 == 0):
        raise ValueError(f"P [16, {n}]: the kernel takes N a multiple of 8, at most {_GATHER_MAX_N}")
    _check_reps(reps)
    out = torch.empty((1, tile), dtype=torch.float32, device=device)
    sink = torch.empty(tile, dtype=torch.int32, device=device)
    _launch("gather_probe", "rt_gather_probe", device, p.data_ptr(), oh.data_ptr(), out.data_ptr(),
            sink.data_ptr(), n, tile, int(reps))
    return out


def _skinny(name, fn, l, r, reps):
    device = _cuda_only(name, r)
    m = l.shape[0] if l.dim() == 2 else -1
    tile = r.shape[1] if r.dim() == 2 else -1
    _check_tensor("l", l, torch.float32, (m, 8), device)
    _check_tensor("r", r, torch.float32, (8, tile), device)
    if not (0 < m <= _SKINNY_MAX_M and m % 16 == 0):
        raise ValueError(f"L [{m}, 8]: the kernel takes M a multiple of 16, at most {_SKINNY_MAX_M}")
    _check_reps(reps)
    out = torch.empty((1, tile), dtype=torch.float32, device=device)
    sink = torch.empty(tile, dtype=torch.int32, device=device)
    _launch(name, fn, device, l.data_ptr(), r.data_ptr(), out.data_ptr(), sink.data_ptr(), m, tile, int(reps))
    return out


def skinny_probe(l, r, reps):
    """`skinny_probe_kernel` at HIGHEST: L [M, 8] f32, R [8, tile] f32 ->
    [1, tile], the sum over `reps` of row 0 of L @ R (3xTF32 on the tensor
    cores: float32 accuracy), with R += 1e-12 row 0 after each rep. The
    other rows go to a discarded per-column checksum, which keeps them
    computed."""
    return _skinny("skinny_probe", "rt_skinny_probe", l, r, reps)


def skinny_default_probe(l, r, reps):
    """`skinny_probe_kernel` at DEFAULT: as `skinny_probe`, but each rep
    rounds L and the current R to bf16 and takes one bf16 pass, summed in
    float32 (R and the sums stay float32)."""
    return _skinny("skinny_probe_default", "rt_skinny_default_probe", l, r, reps)


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} ({lib.rt_error_string(err).decode()})"
        )
