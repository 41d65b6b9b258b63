"""PNG IO for the demo gallery and golden tests, on the standard library.

8-bit greyscale, RGB and RGBA, non-interlaced. `read_png` undoes all five
PNG row filters, so it reads files from other writers too.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, image) -> None:
    """Write an (H, W[, 1|3|4]) uint8 or f32-in-[0,1] array as PNG."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"unsupported channel count {c}")
    # Filter type 0 (none) on every row.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG -> (H, W[, C]) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or interlace != 0 or color_type not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG format {header}")
    c = _CHANNELS[color_type]
    stride = w * c
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            # Left-dependent filters run pixel by pixel.
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, c):
                left = cur[x - c:x] if x else np.zeros(c, np.int32)
                up = prev[x:x + c]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) // 2
                else:
                    upleft = prev[x - c:x] if x else np.zeros(c, np.int32)
                    pred = _paeth(left, up, upleft)
                cur[x:x + c] = (line[x:x + c] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad filter type {kind}")
        out[y] = cur
        prev = cur
    img = out.astype(np.uint8).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
