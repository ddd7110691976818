"""PPM (P3) image encoding and decoding.

Matches the reference's output contract exactly: text `P3\\n{w} {h}\\n255`
header then one "r g b" triplet per pixel, rows top-to-bottom
(reference: src/gpu/camera.h:197-210 `output_image`,
src/cpu/main.cc:109-121). Image payload goes to stdout, logs to stderr —
the reference's entire CLI contract (`./main > out.ppm`,
reference: script/windows/rt-utility.psm1:33-47).

Encoding prefers the native C++ encoder (native/ppm_encoder.cc via
ctypes) when built — text-formatting a 1920x1080 frame in pure Python is
tens of ms of interpreter time; the native path is a single buffer pass.
Falls back to a vectorized NumPy implementation.

A copy of ray_tracing_in_one_weekend_tpu/utils/ppm.py: that package's
`__init__` imports jax and flax, which the port never does. This module
sits at the same depth, so it finds the same repo-root `native/`.
"""

from __future__ import annotations

import io
import os
from typing import IO

import numpy as np

_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """Find and bind native/libppm_encoder.so (built by native/build.sh)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for candidate in (
        os.path.join(here, "native", "libppm_encoder.so"),
        os.path.join(here, "libppm_encoder.so"),
    ):
        if os.path.exists(candidate):
            lib = ctypes.CDLL(candidate)
            lib.ppm_encode_p3.restype = ctypes.c_longlong
            lib.ppm_encode_p3.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_longlong,
            ]
            _NATIVE = lib
            break
    return _NATIVE


def encode_p3(image_uint8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> P3 text bytes."""
    img = np.ascontiguousarray(np.asarray(image_uint8, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8 image, got {img.shape}")
    h, w = img.shape[:2]

    lib = _load_native()
    if lib is not None:
        import ctypes

        # worst case: "255 255 255\n" = 12 bytes/pixel + header
        cap = 12 * h * w + 64
        buf = ctypes.create_string_buffer(cap)
        n = lib.ppm_encode_p3(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, buf, cap
        )
        if n > 0:
            return buf.raw[:n]

    header = f"P3\n{w} {h}\n255\n".encode()
    flat = img.reshape(-1, 3)
    body = "\n".join(f"{r} {g} {b}" for r, g, b in flat.tolist()).encode()
    return header + body + b"\n"


def write_ppm(image_uint8: np.ndarray, stream_or_path: IO[bytes] | str) -> None:
    data = encode_p3(image_uint8)
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "wb") as f:
            f.write(data)
    else:
        stream = stream_or_path
        if isinstance(stream, io.TextIOBase):
            stream.write(data.decode())
        else:
            stream.write(data)


def read_ppm(path_or_bytes) -> np.ndarray:
    """Parse a P3 (text) or P6 (binary) PPM into uint8 [H, W, 3].

    Used by the golden-image test harness to compare against outputs of
    the reference CPU build.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    # Tokenize header, skipping '#' comments.
    tokens = []
    pos = 0
    while len(tokens) < 4 and pos < len(data):
        # skip whitespace
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])

    if magic == b"P3":
        vals = np.array(data[pos:].split(), dtype=np.int64)
        img = vals.reshape(h, w, 3)
    elif magic == b"P6":
        pos += 1  # single whitespace after maxval
        img = np.frombuffer(data[pos : pos + w * h * 3], dtype=np.uint8).reshape(h, w, 3)
    else:
        raise ValueError(f"unsupported PPM magic {magic!r}")
    if maxval != 255:
        img = (img.astype(np.float64) * 255.0 / maxval).round()
    return img.astype(np.uint8)
