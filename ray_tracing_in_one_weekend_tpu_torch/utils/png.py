"""PNG encoding and decoding with the standard library only.

The JAX CLI's `--png` writes through PIL, which the port does not depend
on (the GPU machines it runs on need not have it). An 8-bit RGB image is
a few lines of the PNG format: the signature, an IHDR chunk, the rows
each behind filter byte 0 (none) in one zlib stream (IDAT), and IEND.

Reading is the other half, for the 8-bit RGB and RGBA images that PIL
and this module write (the golden and the gallery renders): every row
may carry any of the five filter types (PIL picks one a row), so
`read_png` undoes them all.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# IHDR color types read: RGB and RGBA, 3 and 4 bytes a pixel at 8 bits.
_BYTES_PER_PIXEL = {2: 3, 6: 4}


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


def _chunks(data: bytes):
    """(kind, body) of each chunk after the signature, up to IEND; raises on
    a truncated chunk or a bad CRC."""
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG ends before its IEND chunk")
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} has a bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> uint8 [H, W, bpp].

    `rows` is [H, 1 + W * bpp]: each row's filter type, then its filtered
    bytes. A byte is rebuilt from the rebuilt bytes to its left (a, one
    pixel back), above (b) and above-left (c), so Sub, Average and Paeth
    chain along a row. Pixel (r, i) depends only on pixels whose r + i is
    smaller: the loop runs over the H + W - 1 anti-diagonals r + i, each
    one vectorized over its rows and channels. The image is held skewed
    so that each anti-diagonal is one contiguous slice: pixel (r, i)
    at [r + i + 2, r + 1], with a zero row 0 and zero columns 0 and 1 for
    the missing neighbours of the first row and column.
    """
    h = rows.shape[0]
    w = (rows.shape[1] - 1) // bpp
    types = rows[:, 0]
    if types.size and int(types.max()) > 4:
        raise ValueError(f"PNG row filter type {int(types.max())} is not one of 0-4")
    n_diag = h + w + 1
    skewed = np.zeros((n_diag, h + 1, bpp), np.int16)
    item = skewed.itemsize
    # view[r + 1, i] is skewed[r + i + 2, r + 1]: the flat offset of that
    # element is (r + 1) (h + 2) bpp + i (h + 1) bpp + (h + 1) bpp.
    view = np.lib.stride_tricks.as_strided(
        skewed.reshape(-1)[(h + 1) * bpp :], shape=(h + 1, w, bpp),
        strides=((h + 2) * bpp * item, (h + 1) * bpp * item, item), writeable=True)
    view[1:] = rows[:, 1:].reshape(h, w, bpp)
    for d in range(2, n_diag):
        lo, hi = max(1, d - w), min(h, d - 1)  # skewed rows r + 1 on this diagonal
        f = skewed[d, lo : hi + 1]
        a = skewed[d - 1, lo : hi + 1]
        b = skewed[d - 1, lo - 1 : hi]
        c = skewed[d - 2, lo - 1 : hi]
        t = types[lo - 1 : hi, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(t == 3, (a + b) >> 1,
                                                                np.where(t == 4, paeth, 0))))
        skewed[d, lo : hi + 1] = (f + pred) & 0xFF
    return view[1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG, not interlaced -> uint8 [H, W, 3]
    (alpha dropped). Raises ValueError on anything else: another bit
    depth, a palette or grey image, interlacing, a bad CRC or a short
    image stream."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR chunk of {len(body)} bytes, 13 expected")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}; only 8 is read")
    if color not in _BYTES_PER_PIXEL:
        raise ValueError(f"PNG color type {color}; only RGB (2) and RGBA (6) are read, no palette or grey")
    if compression != 0 or filtering != 0:
        raise ValueError(f"PNG compression {compression}, filter method {filtering}; only 0 is defined")
    if interlace != 0:
        raise ValueError("PNG is interlaced; only non-interlaced images are read")
    bpp = _BYTES_PER_PIXEL[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG image stream holds {len(raw)} bytes, {h * (1 + w * bpp)} expected")
    pixels = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), bpp)
    return np.ascontiguousarray(pixels[..., :3])
