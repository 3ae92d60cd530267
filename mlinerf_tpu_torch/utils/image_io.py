"""Image input and output: float maps to 8-bit RGB, and PNG files written
and read with the standard library (``zlib`` and ``struct``), so nothing
beyond numpy is needed to save a render or to score one."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np


def to_uint8(image: np.ndarray, from_range: Tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """[H,W,C] or [C,H,W] float -> [H,W,3] uint8, rescaled from from_range."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[0] in (1, 3, 4) and img.shape[-1] not in (1, 3, 4):
        img = np.moveaxis(img, 0, -1)
    lo, hi = from_range
    img = (img - lo) / max(hi - lo, 1e-12)
    img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def save_image(path: str, image: np.ndarray, from_range: Tuple[float, float] = (0.0, 1.0)):
    """Write ``image`` (see :func:`to_uint8`) as an 8-bit RGB PNG."""
    img = to_uint8(image, from_range)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"save_image writes RGB; got {c} channels")
    # Each scanline starts with filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header) + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type: grey, RGB, RGBA


def _unfilter_row(ftype: int, row: bytearray, prior: bytearray, bpp: int) -> bytearray:
    """Undo one scanline's PNG filter in place (``prior`` is the row above,
    already reconstructed; zeros for the first row)."""
    n = len(row)
    if ftype == 0:
        pass
    elif ftype == 1:  # Sub
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif ftype == 2:  # Up
        row[:] = ((np.frombuffer(row, np.uint8).astype(np.uint16) + np.frombuffer(prior, np.uint8)) & 0xFF) \
            .astype(np.uint8).tobytes()
    elif ftype == 3:  # Average
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: unknown row filter {ftype}")
    return row


def load_image(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey, RGB or RGBA PNG as float32
    [H,W,C] in [0,1] (C = 1, 3 or 4). Every other PNG raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, RGB and RGBA PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    prior = bytearray(stride)
    for y in range(h):
        start = y * (stride + 1)
        prior = _unfilter_row(raw[start], bytearray(raw[start + 1:start + 1 + stride]), prior, c)
        out[y] = np.frombuffer(prior, np.uint8)
    return out.reshape(h, w, c).astype(np.float32) / np.float32(255.0)
