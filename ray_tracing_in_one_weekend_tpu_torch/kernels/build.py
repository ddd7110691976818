"""Build the CUDA kernels of `csrc/` and bind them to PyTorch with ctypes.

The sources are compiled with nvcc into one shared library with a plain C
interface under `build/kernels/` at the repo root, at first use, and
again whenever a hash of the sources and flags changes (the hash names
the library). Each `.cu` file is compiled by its own nvcc, all started
together, and the objects are linked into the library. No PyTorch header
is compiled, so a build takes seconds.

`render_pass` is the wrapper of `csrc/render_kernel.cu`;
`threefry_render` that of `csrc/threefry_render_kernel.cu` (the jnp
backend's forward on threefry keys); `threefry_record` (the keyed train
step's forward, which records its paths) and `threefry_reverse` (chained
with `grad_reduce` in `threefry_grad_pass`) those of the two kernels of
`csrc/threefry_grad_kernel.cu`; `grad_replay`,
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
`threefry_grid` the persistent grid of the keyed kernel; `path_slots`
where the keyed reverse writes each path's events.
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

from ray_tracing_in_one_weekend_tpu_torch.utils.spans import sync

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
    "render_kernel": 0, "threefry_render_kernel": 0, "threefry_record": 0, "threefry_record_rerun": 0,
    "threefry_reverse": 0,
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


def _run_all(cmds) -> list[str]:
    """Run the commands side by side; raise if any fails, else return each
    one's output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


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
        log = "".join(_run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(p), "-o", str(o)]
                                for p, o in zip(units, objs)]))
        log += "".join(_run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]]))
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
        lib.rt_threefry_record_blocks_per_sm.restype = i32
        lib.rt_threefry_record_blocks_per_sm.argtypes = [i32]
        lib.rt_threefry_record.restype = i32
        lib.rt_threefry_record.argtypes = [
            ptr, i32, ptr, ptr, i32,  # table, n_spheres, cam, pix, n
            ctypes.c_uint, ctypes.c_uint, i32, i32, i32,  # key0, key1, sample_offset, spp, max_depth
            ptr, ptr, ptr,  # out, work, queue
            ptr, ctypes.c_longlong, ptr, ptr, ptr, ptr,  # records, capacity, total, path_count, path_last, stream
        ]
        lib.rt_threefry_reverse.restype = i32
        lib.rt_threefry_reverse.argtypes = [
            ptr, ptr, ptr, i32, i32,  # table, cam, g, n, spp
            ptr, ctypes.c_longlong, ptr, ptr, ptr,  # records, capacity, path_last, path_count, slots
            ptr, ctypes.c_longlong, ptr, ptr,  # events, n_events, queue, stream
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
    "threefry_record_kernel", whose block is always 128 threads, or
    "grad_reduce_chunks", always 256) at `tile` threads a block for a scene
    of `n_spheres`: the CUDA runtime's occupancy from the kernel's
    registers and shared memory."""
    lib = load()
    if kernel == "sweep_probe":
        n = lib.rt_sweep_probe_blocks_per_sm(n_spheres)
    elif kernel == "threefry_render_kernel":
        n = lib.rt_threefry_blocks_per_sm(n_spheres)
    elif kernel == "threefry_record_kernel":
        n = lib.rt_threefry_record_blocks_per_sm(n_spheres)
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
    with sync("replay_work"):
        whole = torch.equal(work.round(), work)
    if not whole:
        raise ValueError("work must hold whole bounce counts")

    ev_start, ev_count = event_slots(pix, work, pixel_offset, n_live)
    with sync("replay_events"):
        n_events = int(ev_count.sum())
    records = torch.empty((n_events, 16), dtype=torch.float32, device=device)
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_grad_replay(
            table.data_ptr(), n_spheres, cam_vec.data_ptr(), pix.data_ptr(), ev_start.data_ptr(),
            ev_count.data_ptr(), records.data_ptr(), flags.data_ptr(), n_lanes, tile, n_live, seed,
            sample_offset, int(spp), int(max_depth), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "grad_replay_kernel")
    LAUNCHES["grad_replay"] += 1
    with sync("replay_flags"):
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


@dataclasses.dataclass
class Recording:
    """The paths of a recording forward (`threefry_record`, or its plain
    version `ops/cuda_threefry.record_plain`): path k = position x spp +
    sample of the positions `pix`. The arena holds one 64-byte record a
    sweep in the order the sweeps were made (int fields as int32 bits): 0-2
    the pre-bounce o, 3-5 d, 6-8 att, 9 the winning sphere (-1 for a miss),
    10-11 the sample's trace key, 12 the bounce index, 13 how the path goes
    on (0 on, 1 ends without radiance, 2 ends at the sky), 14-15 the arena
    index (int64) of the same path's previous record, -1 at its first: the
    PCG replay's layout in words 0-13. `total` counts the sweeps made: more
    than the arena holds when it ran out, and then the records are
    incomplete (`threefry_grad_pass` records again at that size)."""

    arena: torch.Tensor  # [capacity, 16] f32
    total: torch.Tensor  # [1] int64, on the arena's device
    path_count: torch.Tensor  # [n * spp] int32, each path's sweeps
    path_last: torch.Tensor  # [n * spp] int64, the arena index of each path's last record
    pix: torch.Tensor  # [n] int32 global pixel ids
    table: torch.Tensor  # [N, 16] f32, the transposed packed scene
    cam_vec: torch.Tensor  # [24] f32
    key: tuple  # the base key's two words
    sample_offset: int
    spp: int
    max_depth: int

    @property
    def capacity(self) -> int:
        return self.arena.shape[0]


# The last exact count of sweeps of a recording forward, by (positions, spp,
# max_depth, spheres): the next arena holds that many and a sixteenth more
# (a step after an SGD update sweeps a little more or less). Before any,
# ARENA_FIRST_SWEEPS sweeps a path (the bench preset's cover scene: 2.84).
_ARENA_TOTALS: dict = {}
ARENA_MARGIN = 16
ARENA_FIRST_SWEEPS = 3


def arena_capacity(n: int, spp: int, max_depth: int, n_spheres: int) -> int:
    """Records the next recording forward's arena holds for these shapes."""
    total = _ARENA_TOTALS.get((n, spp, max_depth, n_spheres))
    if total is None:
        return n * spp * min(max_depth, ARENA_FIRST_SWEEPS)
    return total + total // ARENA_MARGIN


def path_slots(pix, path_count, spp: int, pixel_offset: int, n_live: int):
    """Where the keyed reverse writes each path's events -> (slots [n * spp]
    int64, n_events: a 0-d int64 tensor), on the device, with no host sync.

    Path k = position x spp + sample writes the event of its bounce d to
    slot slots[k] + d: the exclusive prefix sum of the paths' sweeps
    (`path_count`) in (pixel id, sample) order, i.e. `event_slots`'
    ev_start of the position plus the sweeps of the pixel's earlier
    samples, so the events lie where the replay's records lay and the
    reduction sums them in the same order for any order of `pix`. Pad
    positions (ids outside [pixel_offset, n_live)) own no slots: -1."""
    n = pix.shape[0]
    local = pix.to(torch.int64) - pixel_offset
    live = (local >= 0) & (pix < n_live)
    counts = torch.where(live[:, None], path_count.reshape(n, spp).to(torch.int64), 0)
    # The sweeps of each pixel's earlier samples, from one flat scan in
    # position order (a scan along the samples' short rows is far slower).
    flat = counts.reshape(-1)
    before = (torch.cumsum(flat, 0) - flat).reshape(n, spp)
    earlier = before - before[:, :1]
    work = earlier[:, -1] + counts[:, -1]
    order = torch.argsort(torch.where(live, local, 1 << 40), stable=True)
    start = torch.empty_like(work)
    start[order] = torch.cumsum(work[order], 0) - work[order]
    return torch.where(live[:, None], start[:, None] + earlier, -1).reshape(-1), work.sum()


def threefry_record(table, cam_vec, pix, key, sample_offset, spp, max_depth, capacity: int | None = None):
    """`threefry_record_kernel` on CUDA tensors: the keyed forward of
    `threefry_render` (same arguments; see there) that also records its
    paths -> (out [n, 3] f32, work [n] int32, `Recording`). The image and
    the work map are `threefry_render`'s bits. The arena holds `capacity`
    records (default `arena_capacity`: the last exact count at these
    shapes, with a margin); the sweeps past it are counted in `total` and
    not written. No host sync: `threefry_grad_pass` reads `total`."""
    device = pix.device
    n, n_spheres, k0, k1 = _check_keyed(table, cam_vec, pix, key, sample_offset, spp, max_depth, device,
                                        "threefry_record")
    lib = load()
    capacity = arena_capacity(n, spp, max_depth, n_spheres) if capacity is None else int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity ({capacity}) must be >= 0")
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    work = torch.empty((n,), dtype=torch.int32, device=device)
    arena = torch.empty((capacity, 16), dtype=torch.float32, device=device)
    total = torch.zeros((1,), dtype=torch.int64, device=device)
    path_count = torch.empty((n * spp,), dtype=torch.int32, device=device)
    path_last = torch.empty((n * spp,), dtype=torch.int64, device=device)
    rec = Recording(arena, total, path_count, path_last, pix, table, cam_vec, (k0, k1), int(sample_offset),
                    int(spp), int(max_depth))
    if n == 0:
        return out, work, rec
    queue = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_threefry_record(
            table.data_ptr(), n_spheres, cam_vec.data_ptr(), pix.data_ptr(), n, k0, k1, int(sample_offset),
            int(spp), int(max_depth), out.data_ptr(), work.data_ptr(), queue.data_ptr(), arena.data_ptr(),
            capacity, total.data_ptr(), path_count.data_ptr(), path_last.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "threefry_record_kernel")
    LAUNCHES["threefry_record"] += 1
    return out, work, rec


def threefry_grad_pass(rec: Recording, g, pixel_offset, n_live):
    """The keyed backward on CUDA tensors -> [16, N] f32, the cotangent of
    the packed scene: `threefry_reverse` on the recording's paths, then
    `grad_reduce` over the events. `rec` as `threefry_record` returned it,
    every id of its `pix` in [pixel_offset, n_live) (others are pads and
    add nothing); g [3, n] f32, each position's radiance cotangent of one
    sample. One host sync reads the sweeps made and the events' count. If
    the arena ran out, the recording forward runs once more at exactly the
    sweeps made (counted in LAUNCHES["threefry_record_rerun"]); its paths
    are the same, so nothing is truncated."""
    slots, n_events = path_slots(rec.pix, rec.path_count, rec.spp, int(pixel_offset), int(n_live))
    with sync("arena_total"):
        total, n_events = torch.stack([rec.total[0], n_events]).tolist()
    rec = complete_recording(rec, total)
    return grad_reduce(threefry_reverse(rec, slots, n_events, g, total), rec.table.shape[0])


def complete_recording(rec: Recording, total: int) -> Recording:
    """`rec`, whose forward made `total` sweeps (`int(rec.total)`), or, if
    its arena ran out, the recording forward once more at exactly `total`
    records (counted in LAUNCHES["threefry_record_rerun"] as well as
    LAUNCHES["threefry_record"]): the same paths, every record kept. The
    count sizes the next arena at these shapes (`arena_capacity`)."""
    _ARENA_TOTALS[(rec.pix.shape[0], rec.spp, rec.max_depth, rec.table.shape[0])] = total
    if total <= rec.capacity:
        return rec
    _, _, rec = threefry_record(rec.table, rec.cam_vec, rec.pix, rec.key, rec.sample_offset, rec.spp,
                                rec.max_depth, capacity=total)
    LAUNCHES["threefry_record_rerun"] += 1
    return rec


def threefry_reverse(rec: Recording, slots, n_events: int, g, total: int):
    """`threefry_reverse_kernel` on CUDA tensors: each thread walks a path
    at a time, from its last record to its first along the links, and
    writes the event of its bounce d to slot slots[k] + d -> events
    [n_events, 16]
    f32 in `grad_reverse`'s layout: word 0 the winning sphere as int32 bits
    (-1 for none: a miss, or a path that ends without radiance), words
    1-13 the cotangent of its rows 0-3, 5-9, 12-15 (rows 12-15 zero: the
    keyed sweep reads center and radius), words 14-15 zero.

    `rec` as `threefry_record` returned it, `total` its sweeps made (which
    must fit the arena); `slots` and `n_events` as `path_slots` gives them
    (n_events as an int); g [3, n] f32, each position's radiance cotangent
    of one sample. The arena is read, not written."""
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"threefry_reverse runs on CUDA tensors, got {device}")
    n, spp, capacity = rec.pix.shape[0], rec.spp, rec.capacity
    if total > capacity:
        raise ValueError(f"threefry_reverse: the arena holds {capacity} records of the {total} sweeps made "
                         "(record again at that size)")
    _check_grad_tables(rec.table, rec.cam_vec, device)
    _check_tensor("g", g, torch.float32, (3, n), device)
    _check_tensor("records", rec.arena, torch.float32, (capacity, 16), device)
    _check_tensor("path_last", rec.path_last, torch.int64, (n * spp,), device)
    _check_tensor("path_count", rec.path_count, torch.int32, (n * spp,), device)
    _check_tensor("slots", slots, torch.int64, (n * spp,), device)
    if n_events < 0:
        raise ValueError(f"n_events ({n_events}) must be >= 0")
    lib = load()
    events = torch.empty((int(n_events), 16), dtype=torch.float32, device=device)
    queue = torch.zeros((1,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.rt_threefry_reverse(
            rec.table.data_ptr(), rec.cam_vec.data_ptr(), g.data_ptr(), n, spp, rec.arena.data_ptr(), capacity,
            rec.path_last.data_ptr(), rec.path_count.data_ptr(), slots.data_ptr(), events.data_ptr(),
            int(n_events), queue.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "threefry_reverse_kernel")
    LAUNCHES["threefry_reverse"] += 1
    return events


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
