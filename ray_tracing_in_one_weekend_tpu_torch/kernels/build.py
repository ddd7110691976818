"""Build the CUDA kernels of `csrc/` and bind them to PyTorch with ctypes.

The sources are compiled with nvcc into one shared library with a plain C
interface under `build/kernels/` at the repo root, at first use, and
again whenever a hash of the sources and flags changes (the hash names
the library). No PyTorch header is compiled, so a build takes seconds.

`render_pass` is the wrapper of `csrc/render_kernel.cu`: it checks its
tensors, allocates the outputs, launches on PyTorch's current stream,
raises if the launch failed, and counts its launches in `LAUNCHES`.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last `reset_launches()`: what a run reads
# to show that its main path went through the kernels.
LAUNCHES = {"render_kernel": 0}

_LIB = None
# The default per-block shared-memory limit (no opt-in), less the kernel's
# static camera vector: up to 766 spheres, and every scene of the port has
# at most 512 slots.
_MAX_TABLE_BYTES = 48 * 1024 - 24 * 4


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library for these sources already existed
    log: str  # nvcc's output, with ptxas' register and shared-memory report


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


def build() -> BuildResult:
    """Compile `csrc/*.cu` unless the library for these sources exists."""
    lib = BUILD_DIR / f"librt_kernels_{source_hash()}.so"
    if lib.exists():
        return BuildResult(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
        *(str(p) for p in _sources() if p.suffix == ".cu"),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return BuildResult(lib, seconds, proc.stdout + proc.stderr)


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
        lib.rt_max_tile.restype = i32
        lib.rt_max_tile.argtypes = []
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
    if not 0 < n_spheres * 64 <= _MAX_TABLE_BYTES:
        raise ValueError(f"{n_spheres} spheres do not fit the kernel's 48 KB shared-memory table")
    lib = load()
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
    if err != 0:
        raise RuntimeError(
            f"render_kernel launch failed: CUDA error {err} "
            f"({lib.rt_error_string(err).decode()})"
        )
    LAUNCHES["render_kernel"] += 1
    return of, oi
