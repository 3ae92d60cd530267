"""Image output: float maps to 8-bit RGB, and PNG files written with the
standard library (``zlib`` and ``struct``), so nothing beyond numpy is
needed to save a render."""

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
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))
