"""Compressed YCbCr TIFFs as Pillow 12.1 reads them: through libtiff 4.7's
TIFFRGBAImage (tif_getimage.c with tif_color.c's TIFFYCbCrToRGB), which
Pillow's TiffDecode.c (_decodeAsRGBA) uses for every compressed YCbCr file
but a JPEG-compressed one in one plane.

Pillow asks libtiff for a block of rows at a time (a strip, or a row of
tiles), rows as stored, and unpacks each RGBA row by the raw mode "RGBX";
then it applies the EXIF orientation itself. So the arrays carry libtiff's
quirks, each mirrored here:

- the samples: blocks of ``hs x vs`` luma samples and one Cb and one Cr, for
  the YCbCrSubsampling libtiff has a routine for (1, 2 or 4 across, 1, 2 or
  4 down, vertical no more than horizontal, or 1x2), libtiff's default 2x2
  where the tag is absent; partial blocks at the right and bottom edges take
  the luma samples inside the image; a planar file only at 1x1;
- the arithmetic: TIFFYCbCrToRGBInit's fixed-point tables from
  YCbCrCoefficients and ReferenceBlackWhite (their defaults where absent),
  float where libtiff computes in float;
- the reads: a strip is decoded only as far as libtiff asks (the whole
  block rows it covers; for 4x4 subsampling with an odd number of blocks
  across, two bytes short per four rows) into a zeroed buffer, and a strip
  whose data runs short or breaks (LZW, ZSTD) reads as what was decoded,
  zeros after it (TIFFRGBAImage carries on past a strip it could not
  decode).

Where libtiff fails the read, or carries on past a strip whose partial
output this module cannot rebuild (a corrupt Deflate or LZMA stream, whose
Python codecs keep none; a JPEG plane; an unreadable strip after the first),
this module raises ValueError.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np

from mlinerf_tpu_torch.utils import image_containers as ic

# PickContigCase's YCbCr routines, (horizontal, vertical) subsampling.
CONTIG_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
_LUMA = (0.299, 0.587, 0.114)  # libtiff's default YCbCrCoefficients
_REF_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)  # its default for a YCbCr file


def _float_field(lay: ic.TiffLayout, tag: int, count: int, default) -> Tuple[np.float32, ...]:
    """A float field as libtiff reads it (RATIONAL num/den in double, then
    float; 0 for a zero denominator); the default where the tag is absent
    or has another count."""
    v = lay.fields.get(tag)
    if v is None:
        return tuple(np.float32(x) for x in default)
    if len(v) == 2 * count and all(isinstance(x, int) for x in v):  # RATIONAL pairs
        return tuple(np.float32(n / d) if d else np.float32(0) for n, d in zip(v[0::2], v[1::2]))
    if len(v) == count and not any(isinstance(x, bytes) for x in v):
        return tuple(np.float32(x) for x in v)
    return tuple(np.float32(x) for x in default)


def _fix(x: np.float32) -> int:
    """tif_color.c FIX: (int32_t)(x * (1L << 16) + 0.5)."""
    return int(float(np.float32(x) * np.float32(65536)) + 0.5)


def _clamp(f, lo, hi):
    return lo if f < lo else (hi if f > hi else f)


def _code2v(c: int, rb: np.float32, rw: np.float32, cr: int) -> np.float32:
    """tif_color.c Code2V: ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB
    or 1), in float."""
    den = np.float32(rw - rb)
    if den == 0:
        den = np.float32(1)
    return np.float32(np.float32(c - int(rb)) * np.float32(cr)) / den


def _clamp_w(f: np.float32) -> int:
    """CLAMPw to +-128 * 32 (a NaN to the minimum), then (int32_t)."""
    lo, hi = np.float32(-4096), np.float32(4096)
    f = lo if not f >= lo else (hi if f > hi else f)
    return int(f)


@functools.lru_cache(maxsize=16)
def ycbcr_tables(luma: Tuple[np.float32, ...], ref: Tuple[np.float32, ...]):
    """TIFFYCbCrToRGBInit's tables, each [256] int64: Y, Cr->R, Cb->B,
    Cr->G and Cb->G (the last with the rounding half), indexed by the
    sample."""
    lr, lg, lb = luma
    two, zero = np.float32(2), np.float32(0)
    f1 = np.float32(two - np.float32(two * lr))
    d1 = _fix(_clamp(f1, zero, two))
    f2 = np.float32(np.float32(lr * f1) / lg)
    d2 = -_fix(_clamp(f2, zero, two))
    f3 = np.float32(two - np.float32(two * lb))
    d3 = _fix(_clamp(f3, zero, two))
    f4 = np.float32(np.float32(lb * f3) / lg)
    d4 = -_fix(_clamp(f4, zero, two))
    half = 1 << 15
    k128 = np.float32(128)
    y_tab, cr_r, cb_b, cr_g, cb_g = (np.zeros(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = _clamp_w(_code2v(x, np.float32(ref[4] - k128), np.float32(ref[5] - k128), 127))
        cb = _clamp_w(_code2v(x, np.float32(ref[2] - k128), np.float32(ref[3] - k128), 127))
        cr_r[i] = (d1 * cr + half) >> 16
        cb_b[i] = (d3 * cb + half) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + half
        y_tab[i] = _clamp_w(_code2v(x + 128, ref[0], ref[1], 255))
    return y_tab, cr_r, cb_b, cr_g, cb_g


def ycbcr_to_rgba(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables) -> np.ndarray:
    """TIFFYCbCrtoRGB on arrays of uint8 samples -> RGBA uint8 [..., 4]
    (alpha 255, libtiff's PACK)."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[y]
    out = np.empty(y.shape + (4,), np.uint8)
    out[..., 0] = np.clip(yv + cr_r[cr], 0, 255)
    out[..., 1] = np.clip(yv + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(yv + cb_b[cb], 0, 255)
    out[..., 3] = 255
    return out


def _contig_samples(buf: np.ndarray, rows: int, cols: int, row_blocks: int, hs: int, vs: int):
    """(Y, Cb, Cr) [rows, cols] of packed YCbCr blocks: each block hs*vs
    luma samples row by row, then Cb and Cr; ``row_blocks`` blocks to a
    block row."""
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    base = ((r // vs) * row_blocks + c // hs) * (hs * vs + 2)
    return buf[base + (r % vs) * hs + c % hs], buf[base + hs * vs], buf[base + hs * vs + 1]


def read_rgba(path: str, data: bytes, lay: ic.TiffLayout) -> np.ndarray:
    """The RGBA rows Pillow's _decodeAsRGBA hands its unpacker, [H, W*4]
    uint8, as stored (Pillow applies the orientation); see the module's
    docstring."""
    bits = (lay.bits[0],) * lay.libtiff_samples if lay.libtiff_samples else lay.bits  # libtiff's samples
    if bits != (8, 8, 8):
        raise ValueError(f"{path}: TIFF: libtiff's TIFFRGBAImage cannot handle YCbCr with bits {bits} "
                         "(it converts 8-bit YCbCr of 3 samples)")
    if lay.byte_counts is None:
        raise ValueError(f"{path}: TIFF: missing required StripByteCounts")
    separate = lay.planar == 2
    hs, vs = ic.ycbcr_subsampling(path, data, lay)
    if hs not in (1, 2, 4) or vs not in (1, 2, 4):
        raise ValueError(f"{path}: TIFF: invalid YCbCr subsampling {hs}x{vs}")
    if (hs, vs) not in (((1, 1),) if separate else CONTIG_SUBSAMPLINGS):
        raise ValueError(f"{path}: TIFF: libtiff's TIFFRGBAImage has no routine for YCbCr subsampling {hs}x{vs} "
                         f"in planar configuration {lay.planar}")
    luma = _float_field(lay, 529, 3, _LUMA)
    if any(math.isnan(v) for v in luma) or abs(float(luma[1])) < 1e-10:
        raise ValueError(f"{path}: TIFF: invalid values for the YCbCrCoefficients tag {luma}")
    ref = _float_field(lay, 532, 6, _REF_BLACK_WHITE)
    if not all(np.float32(-0x7FFFFFFF + 128) < v < np.float32(0x7FFFFFFF) for v in ref):
        raise ValueError(f"{path}: TIFF: invalid values for the ReferenceBlackWhite tag {ref}")
    tables = ycbcr_tables(luma, ref)
    w, h = lay.width, lay.height
    if lay.tiles:
        tw, th = lay.tiles
        if tw <= 0 or th <= 0:
            raise ValueError(f"{path}: TIFF: tile of {tw}x{th}")
        block = th
    else:
        rps = lay.rows_per_strip
        if rps <= 0:
            raise ValueError(f"{path}: TIFF: {rps} rows per strip")
        block = h if rps >= 2 ** 32 - 1 else rps
    if block * w * 4 > 2 ** 31 - 1:
        raise ValueError(f"{path}: TIFF: a block of {block} rows of {w} RGBA pixels overflows Pillow's buffer")
    read = _tile_reader(path, data, lay, hs, vs, tables) if lay.tiles else _strip_reader(path, data, lay, hs, vs,
                                                                                        tables)
    out = np.empty((h, w, 4), np.uint8)
    for y in range(0, h, block):
        out[y:y + block] = read(y, min(block, h - y))
    return out.reshape(h, w * 4)


def _decoder(path: str, data: bytes, lay: ic.TiffLayout) -> Callable:
    """decode(index, size, width, rows, row_bytes, what): strip or tile
    ``index`` (``rows`` rows of ``width`` pixels) decoded to ``size`` bytes
    as libtiff's TIFFReadEncodedStrip or TIFFReadTile decodes it for
    TIFFRGBAImage (a planar JPEG plane as coded), the predictor undone over
    rows of ``row_bytes``."""

    blocks = []  # an old-style JPEG's packed YCbCr, decoded once

    def decode(index, size, width, rows, row_bytes, what):
        if lay.compression == 6:
            if not blocks:
                hs, vs = ic.ycbcr_subsampling(path, data, lay)
                row_block_bytes = -(-lay.width // hs) * (hs * vs + 2)
                try:
                    packed = ic.ojpeg_blocks(path, data, lay, hs, vs)
                except ValueError as e:
                    if len(lay.offsets) != 1 or "Unexpected error" not in str(e):
                        raise
                    # libjpeg failed inside the strip's data (tif_ojpeg.c's
                    # source): TIFFRGBAImage goes on past the strip,
                    # converting the buffer it zeroed for it.
                    packed = np.zeros(-(-lay.height // vs) * row_block_bytes, np.uint8)
                blocks.append((packed, row_block_bytes, vs))
            packed, row_block_bytes, vs = blocks[0]
            start = index * lay.rows_per_strip // vs * row_block_bytes
            return packed[start:start + size]
        chunk, start = ic.chunk_bytes(path, data, lay, index, what)
        if lay.compression == 7:  # a plane of a planar file, as coded
            return ic._jpeg_decode(path, data, lay, chunk, width, rows, rows, False, 1, what)[:size]
        buf = ic._decompress(path, lay, chunk, start, width, rows, size, what, partial_ok=True)
        if lay.compression in ic._PREDICTED and lay.predictor != 1:
            if size % row_bytes:
                raise ValueError(f"{path}: TIFF: the predictor's rows of {row_bytes} bytes do not divide {what}")
            ic._libtiff_rows(path, lay, buf, size // row_bytes, row_bytes, 1 if lay.planar == 2 else 3)
        return buf

    return decode


def _strip_reader(path, data, lay, hs, vs, tables) -> Callable:
    """read(y, rows) -> RGBA [rows, W, 4]: gtStripContig / gtStripSeparate
    for the rows from y (a whole strip)."""
    w, h = lay.width, lay.height
    rps = lay.rows_per_strip
    decode = _decoder(path, data, lay)
    if lay.planar == 2:
        per_plane = -(-h // min(rps, h))

        def read_separate(y, rows):
            buf = np.zeros((3, w * min(rps, h)), np.uint8)
            strip = y // rps
            size = min(rows, rps - y % rps) * w
            for plane in range(3):
                index = plane * per_plane + strip
                buf[plane, :size] = decode(index, size, w, rows, w, f"strip {index}")
            y_, cb, cr = (buf[p, :rows * w].reshape(rows, w) for p in range(3))
            return ycbcr_to_rgba(y_, cb, cr, tables)

        return read_separate
    block_bytes = hs * vs + 2
    row_blocks = -(-w // hs)
    sampling_row = row_blocks * block_bytes
    scanline = sampling_row // vs  # TIFFScanlineSize, rounded down

    def strip_size(nrows):
        return -(-nrows // vs) * sampling_row

    def read_contig(y, rows):
        buf = np.zeros(strip_size(min(rps, h)), np.uint8)  # gtStripContig's buffer, fresh for each block
        strip = y // rps
        in_strip = min(rps, h - strip * rps)
        rows_sub = -(-rows // vs) * vs
        size = min(strip_size(in_strip), ((y % rps) + rows_sub) * scanline)
        buf[:size] = decode(strip, size, w, in_strip, scanline, f"strip {strip}")
        pos = (y % rps) * scanline
        y_, cb, cr = _contig_samples(buf[pos:], rows, w, row_blocks, hs, vs)
        return ycbcr_to_rgba(y_, cb, cr, tables)

    return read_contig


def _tile_reader(path, data, lay, hs, vs, tables) -> Callable:
    """read(y, rows) -> RGBA [rows, W, 4]: gtTileContig / gtTileSeparate for
    the row of tiles from y, each tile read whole and clipped to the
    image."""
    w, h = lay.width, lay.height
    tw, th = lay.tiles
    across, down = -(-w // tw), -(-h // th)
    decode = _decoder(path, data, lay)
    separate = lay.planar == 2
    if separate:
        size, row_bytes = tw * th, tw
    else:
        row_blocks = -(-tw // hs)
        size, row_bytes = -(-th // vs) * row_blocks * (hs * vs + 2), tw * 3

    def read(y, rows):
        ty = y // th
        out = np.empty((rows, w, 4), np.uint8)
        for tx in range(across):
            x0, cols = tx * tw, min(tw, w - tx * tw)
            if separate:
                planes = [decode(p * across * down + ty * across + tx, size, tw, th, row_bytes,
                                 f"tile {p * across * down + ty * across + tx}").reshape(th, tw) for p in range(3)]
                y_, cb, cr = (pl[:rows, :cols] for pl in planes)
            else:
                index = ty * across + tx
                buf = decode(index, size, tw, th, row_bytes, f"tile {index}")
                y_, cb, cr = _contig_samples(buf, rows, cols, row_blocks, hs, vs)
            out[:, x0:x0 + cols] = ycbcr_to_rgba(y_, cb, cr, tables)
        return out

    return read
