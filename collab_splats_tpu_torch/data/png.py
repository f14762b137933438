"""A PNG codec on the standard library: ``zlib`` and ``struct``.

The port reads and writes its PNG files with it, so a run needs no image
library (a machine may lack PIL).  It covers what the pipeline writes and
reads: 8-bit RGB and RGBA (colour types 2 and 6) and 8-bit greyscale
(type 0, read only), non-interlaced, with every filter type (0-4) on read.
PNG is lossless, so a decode equals any other decoder's bit for bit.

The encoder writes one filter type for every row (``filter_type``, Up by
default); each type is computed from the original bytes, so every one is a
vectorised difference.  On read, None, Sub and Up are vectorised per row;
Average and Paeth depend on the bytes just reconstructed and run a loop
over the row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}     # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth_predictor(a, b, c):
    """The Paeth predictor of each byte (int16 arrays)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Filtered bytes [H, W * bpp] of the uint8 rows, all with one type."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                 # the byte to the left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                           # the byte above
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) // 2
    elif filter_type == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]          # the byte above-left
        pred = _paeth_predictor(a, b, c)
    else:
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, filter_type: int = 2) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA) image."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes uint8 [H, W, 3|4], got "
                         f"{img.dtype} {img.shape}")
    h, w, ch = img.shape
    rows = _filter(img.reshape(h, w * ch), ch, filter_type)
    raw = np.concatenate(
        [np.full((h, 1), filter_type, np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Reconstruct one row (uint8) from its filtered bytes and the
    reconstructed row above (zeros for the first row)."""
    if kind == 0:
        return row
    if kind == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:
        return row + prev
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} is not 0-4")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            pred = (left + up[i]) >> 1
        else:
            upleft = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - upleft
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - upleft)
            pred = left if pa <= pb and pa <= pc else (
                up[i] if pb <= pc else upleft)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, C] pixels of PNG bytes (C = 1, 3 or 4 as stored)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off, header, idat = 8, None, []
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        off += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit grey, RGB "
                         "or RGBA, non-interlaced only)")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, ch)
    return out.reshape(h, w, ch)


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write a uint8 [H, W, 3|4] image as a PNG file."""
    Path(path).write_bytes(encode_png(image))


def read_png(path: str | Path) -> np.ndarray:
    """uint8 [H, W, C] pixels of a PNG file."""
    return decode_png(Path(path).read_bytes())
