"""PNG files without an imaging library: 8-bit grey, grey + alpha, RGB and
RGBA, not interlaced — what the gallery builder
(``cli/create_image_features.py``) reads where neither Pillow nor
matplotlib is installed, and what its on-card run writes.

``read_png`` undoes all five scanline filters (None, Sub, Up, Average,
Paeth): None and Up are whole-row numpy operations, Sub a running sum per
channel, Average and Paeth a loop over the row's pixels.  ``write_png``
writes one filter type for every row (None by default) at zlib level 1.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type → samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return line
    if kind == 2:
        return (line + prev).astype(np.uint8)
    if kind == 1:
        out = line.reshape(-1, bpp).astype(np.int64).cumsum(axis=0) % 256
        return out.astype(np.uint8).reshape(-1)
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        c = up[i - bpp] if i >= bpp else 0
        pred = (a + up[i]) // 2 if kind == 3 else _paeth(a, up[i], c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG → uint8 (H, W, C), C the file's channels (1–4)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            W, H, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, grey + "
                         "alpha, RGB or RGBA PNGs are read without Pillow "
                         f"(depth {depth}, colour type {ctype}, interlace "
                         f"{interlace})")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, C)
    return out.reshape(H, W, C)


def write_png(path: str, image: np.ndarray, filter_type: int = 0) -> None:
    """uint8 (H, W) or (H, W, C ≤ 4) → an 8-bit PNG, every row with
    ``filter_type`` 0 (None) or 2 (Up)."""
    im = np.asarray(image, np.uint8)
    if im.ndim == 2:
        im = im[..., None]
    H, W, C = im.shape
    ctype = {v: k for k, v in _CHANNELS.items()}[C]
    rows = im.reshape(H, W * C)
    if filter_type == 2:
        rows = (rows.astype(np.int16) - np.vstack([np.zeros((1, W * C), np.int16),
                                                   rows[:-1]])).astype(np.uint8)
    elif filter_type != 0:
        raise ValueError("write_png writes filter 0 (None) or 2 (Up)")
    body = np.hstack([np.full((H, 1), filter_type, np.uint8), rows]).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body, 1)) + chunk(b"IEND", b""))
