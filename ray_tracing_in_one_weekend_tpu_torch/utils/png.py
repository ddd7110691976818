"""PNG encoding with the standard library only.

The JAX CLI's `--png` writes through PIL, which the port does not depend
on (the GPU machines it runs on need not have it). An 8-bit RGB image is
a few lines of the PNG format: the signature, an IHDR chunk, the rows
each behind filter byte 0 (none) in one zlib stream (IDAT), and IEND.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(u8, path: str) -> None:
    """Write uint8 [H, W, 3] to `path` as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(np.asarray(u8))
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} {list(img.shape)}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, deflate, filter 0, no interlace
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
