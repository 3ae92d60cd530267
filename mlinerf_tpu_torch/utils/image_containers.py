"""TIFF and BMP files read to what Pillow 12.1's ``Image.open`` gives:
``(np.asarray(Image.open(path)), mode)``, bit for bit, with neither Pillow
nor libtiff.

Pillow reads the two containers by different engines, and each quirk of
an engine shows in its arrays, so this module mirrors both:

- BMP (``BmpImagePlugin``): header sizes 12 (OS/2 1.x), 40, 52, 56, 64,
  108 and 124; 1-, 4- and 8-bit palettes (a palette of greys reads as "L",
  or as "1" with two entries), 16-bit BGR 5-5-5 and 5-6-5, 24-bit BGR,
  32-bit BGRX (``BI_RGB``: "RGB", alpha dropped) and the bitfield masks
  Pillow knows, with or without alpha; RLE8 and RLE4 through Pillow's own
  run-length decoder; bottom-up and top-down rows.
- TIFF (``TiffImagePlugin``): the first directory of a classic or a
  little-endian BigTIFF file, its mode from Pillow's ``OPEN_INFO`` table
  (photometric MinIsWhite, MinIsBlack, RGB, palette, CMYK, CIELab; 1, 2,
  4, 8, 12, 16 and 32 bits; unsigned, signed and float samples; extra
  samples 0, 1 and 2), strips or tiles, planar configuration 1 or 2, fill
  order 1 or 2, the EXIF orientation applied. Pillow takes one of three
  routes through a file, and each is mirrored: (R) uncompressed files go
  through Pillow's raw tile decoder, whose rules differ from libtiff's (it
  ignores the predictor, unpacks each plane of a planar file by one letter
  of the raw mode, reads past the strips' byte counts and takes YCbCr as
  RGBX); (S) compressed ones go through libtiff's TIFFReadEncodedStrip and
  TIFFReadTile, whose strips and tiles decode here, then Pillow's
  unpacker: LZW, Adobe Deflate and Deflate, PackBits, LZMA (both through
  utils/stream_codecs.py: Python's zlib and lzma, and for a stream they do
  not read whole csrc/stream_decode.cpp's inflate and XZ), Zstandard
  (csrc/zstd_decode.cpp), JPEG (csrc/jpeg_decode.cpp,
  with the JPEGTables field, a YCbCr file converted to RGB by libjpeg),
  CCITT RLE, RLEW, Group 3 1D and 2D and Group 4, ThunderScan, predictors
  2 and 3, byte swapping to the host's order and libtiff's plane-by-plane
  copy of a planar file; (A) every other compressed YCbCr file goes
  through libtiff's TIFFRGBAImage (utils/tiff_rgba.py: subsampling and
  libtiff's fixed-point YCbCr -> RGB). Old-style JPEG (compression 6),
  which Pillow takes as YCbCr whatever the file says, takes route (A) with
  three samples and (S) with one: libtiff's tif_ojpeg.c rebuilds one
  baseline stream from the JPEGInterchangeFormat's markers or from the
  JPEGQTables, DC and AC tables (``ojpeg_stream``), and libjpeg hands back
  raw component planes, which libtiff packs as TIFF's subsampled YCbCr.

The codecs are ``csrc/container_decode.cpp`` and ``csrc/zstd_decode.cpp``,
host libraries built with g++ into ``build/`` at first use; a failed build
raises, there is no Python fallback. Routes (S) and (A) read the directory
a second time as libtiff does (``libtiff_directory``): the fields it cannot
do without must be well formed, its strip arrays are cut or padded to the
strip count, and its missing byte counts estimated. What Pillow refuses
raises ValueError naming it, as do the few strips whose rows libtiff
leaves undefined (see ``_decompress``) and old-style JPEG in tiles or
planes.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from mlinerf_tpu_torch.utils import stream_codecs

BMP_SIGNATURE = b"BM"
# Pillow's TiffImagePlugin.PREFIXES: classic TIFF in either byte order
# (including the two with the version's bytes swapped) and BigTIFF.
TIFF_SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
# Image.MAX_IMAGE_PIXELS: Image.open refuses an image of more than twice
# this many pixels as a decompression bomb.
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3

_LIB = None


def _lib():
    """``build/libcontainer_decode.so`` (csrc/container_decode.cpp), built
    with g++ at first use; a failed build raises."""
    global _LIB
    from mlinerf_tpu_torch.utils.image_io import _LIB_LOCK

    with _LIB_LOCK:
        if _LIB is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("container_decode")
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            for name, args in (("lzw_decode", [ctypes.c_char_p, i64, ptr, i64]),
                               ("packbits_decode", [ctypes.c_char_p, i64, ptr, i64]),
                               ("predictor_undo", [ptr, i64, i64, i64, i64, i64]),
                               ("bmp_rle_decode", [ctypes.c_char_p, i64, i64, i64, i64, i64, ptr, i64]),
                               ("fax_decode", [ctypes.c_char_p, i64, i64, i64, i64, i64, i64, ptr, ptr, ptr, i64]),
                               ("thunder_decode", [ctypes.c_char_p, i64, i64, i64, ptr])):
                getattr(lib, name).restype = i64
                getattr(lib, name).argtypes = args
            _LIB = lib
        return _LIB


# ---------------------------------------------------------------------------
# Pillow's image memory and its unpackers
# ---------------------------------------------------------------------------

# Modes whose pixels Pillow keeps in four bytes, and the bytes np.asarray
# gives of them (LA and PA keep their alpha in the fourth).
_BANDS = {"LA": [0, 3], "PA": [0, 3], "RGB": [0, 1, 2], "LAB": [0, 1, 2], "RGBA": [0, 1, 2, 3],
          "CMYK": [0, 1, 2, 3]}
_STORE_DTYPE = {"1": np.uint8, "L": np.uint8, "P": np.uint8, "I;16": np.uint16, "I;16B": np.uint16,
                "I": np.int32, "F": np.float32}
# The array dtype of the modes whose samples are wider than a byte.
_ARRAY_DTYPE = {"I;16": "<u2", "I;16B": ">u2", "I": "<i4", "F": "<f4"}
_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# The byte of a four-byte pixel each letter of a raw mode fills, by mode family.
_SLOTS = {"RGB": {"R": 0, "G": 1, "B": 2, "A": 3, "a": 3}, "CMYK": {"C": 0, "M": 1, "Y": 2, "K": 3},
          "LAB": {"L": 0, "A": 1, "B": 2}, "LA": {"L": 0, "A": 3}, "PA": {"P": 0, "A": 3}}


def _new_image(mode: str, h: int, w: int) -> np.ndarray:
    """Pillow's zeroed image memory of ``mode``: [H,W,4] bytes for the
    modes of _BANDS, else [H,W] of the mode's sample type ("1" as 0/255)."""
    if mode in _BANDS:
        return np.zeros((h, w, 4), np.uint8)
    return np.zeros((h, w), _STORE_DTYPE[mode])


def _as_array(mode: str, im: np.ndarray) -> np.ndarray:
    """``np.asarray(im)`` of Pillow's image memory, always [H,W,C]."""
    if mode in _BANDS:
        return np.ascontiguousarray(im[..., _BANDS[mode]])
    if mode == "1":
        return (im != 0)[..., None]
    if mode in _ARRAY_DTYPE:
        return im.astype(_ARRAY_DTYPE[mode])[..., None]
    return im[..., None]


def _bits_of(rows: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Rows of bytes [R, n] -> the first ``count`` values of ``bits`` bits
    each, most significant bit first, [R, count]."""
    if bits == 8:
        return rows[:, :count]
    flat = np.unpackbits(rows, axis=1)[:, :count * bits].reshape(len(rows), count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    out = (flat * weights).sum(-1, dtype=np.uint32)
    return out.astype(np.uint8 if bits < 8 else np.uint16)


def _family(mode: str) -> str:
    return "RGB" if mode in ("RGB", "RGBA") else mode


def raw_bits(raw: str) -> int:
    """Bits per pixel that Pillow's unpacker ``raw`` reads."""
    if raw in ("1", "1;I", "1;R", "1;IR", "P;1", "P;1R"):
        return 1
    if raw.startswith(("L;2", "P;2")):
        return 2
    if raw.startswith(("L;4", "P;4")):
        return 4
    if raw == "I;12":
        return 12
    if raw.startswith(("I;16", "BGR;1")) or (len(raw) == 4 and raw.endswith(";16N")):
        return 16
    if raw.startswith(("I;32", "F;32")) or raw in ("I", "F"):
        return 32
    if ";16" in raw:
        return 16 * len(raw.split(";")[0])
    return 8 * len(raw.split(";")[0])


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's premultiplied RGBa unpacker: colour * 255 // alpha, clipped;
    alpha 0 gives a zero pixel and 255 keeps the colour."""
    rgb, a = px[..., :3].astype(np.int32), px[..., 3:].astype(np.int32)
    div = np.minimum(rgb * 255 // np.maximum(a, 1), 255)
    rgb = np.where(a == 255, rgb, np.where(a == 0, 0, div))
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def unpack(mode: str, raw: str, rows: np.ndarray, count: int) -> np.ndarray:
    """Pillow's unpacker ``raw`` into an image of ``mode``: rows of bytes
    [R, n] -> ``count`` pixels of each row in Pillow's image memory ([R,
    count, 4] bytes, or [R, count] of the mode's sample type). A pair
    Pillow has no unpacker for raises ValueError."""
    r = len(rows)
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if raw in ("L;IR", "P;1R", "P;2R", "P;4R"):  # in OPEN_INFO, but Pillow has no such unpacker
        raise ValueError(f"no unpacker from {raw} to {mode}")
    if raw == "I;16R":  # each byte's bits reversed, then little-endian
        rows, raw = _REVERSED_BITS[rows], "I;16"
    if raw.startswith(("1", "L;2", "L;4", "P;1", "P;2", "P;4")) or raw in ("L", "L;I", "L;R", "P", "P;R"):
        if mode not in ("1", "L", "P") or raw[0] != {"1": "1", "L": "L", "P": "P"}[mode]:
            raise ValueError(f"no unpacker from {raw} to {mode}")
        head, _, flags = raw.partition(";")
        depth = int(flags[0]) if flags[:1] in ("1", "2", "4") else (1 if head == "1" else 8)
        flags = flags.lstrip("124")
        if "R" in flags:
            rows = _REVERSED_BITS[rows]
        v = _bits_of(rows, depth, count)
        if mode == "1":
            v = np.where(v != 0, 255, 0).astype(np.uint8)
        elif mode == "L":
            v = (v * (255 // ((1 << depth) - 1))).astype(np.uint8)
        if "I" in flags:
            v = 255 - v
        return v
    if raw == "PX":  # palette index and a byte skipped
        if mode != "P":
            raise ValueError(f"no unpacker from {raw} to {mode}")
        return rows[:, 0:2 * count:2]
    if raw == "I;12":
        return _bits_of(rows, 12, count).astype(np.uint16)
    single = {"I": "<i4", "F": "<u4", "I;16": "<u2", "I;16N": "<u2", "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2",
              "I;32N": "<u4", "I;32S": "<i4", "I;32BS": ">i4", "F;32F": "<u4", "F;32BF": ">u4"}
    if raw in single:
        targets = {"I;16": ("I;16", "I;16N", "I;16B"), "I;16B": ("I;16B", "I;16N"),
                   "I": ("I", "I;16S", "I;16BS", "I;32N", "I;32S", "I;32BS"), "F": ("F", "F;32F", "F;32BF")}
        if raw not in targets.get(mode, ()):
            raise ValueError(f"no unpacker from {raw} to {mode}")
        size = np.dtype(single[raw]).itemsize
        v = rows[:, :count * size].copy().view(single[raw])
        if mode == "F":
            return v.astype(np.uint32).view(np.float32)
        return v.astype(_STORE_DTYPE[mode]) if mode != "I" else v.astype(np.int64).astype(np.int32)
    if raw in ("BGR;15", "BGR;16"):
        if mode != "RGB":
            raise ValueError(f"no unpacker from {raw} to {mode}")
        p = rows[:, :2 * count].copy().view("<u2").astype(np.int32)
        g_bits, r_shift = (5, 10) if raw == "BGR;15" else (6, 11)
        out = np.full((r, count, 4), 255, np.uint8)
        out[..., 0] = ((p >> r_shift) & 31) * 255 // 31
        out[..., 1] = ((p >> 5) & ((1 << g_bits) - 1)) * 255 // ((1 << g_bits) - 1)
        out[..., 2] = (p & 31) * 255 // 31
        return out
    letters, _, suffix = raw.partition(";")
    if mode not in _BANDS:
        raise ValueError(f"no unpacker from {raw} to {mode}")
    family = _family(mode)
    if mode == "LAB" and letters != "LAB" or suffix not in ("", "R", "16L", "16B", "16N"):
        raise ValueError(f"no unpacker from {raw} to {mode}")
    slots = _SLOTS[family]
    if any(ch not in slots and ch != "X" for ch in letters) or (suffix == "R" and letters != "RGB"):
        raise ValueError(f"no unpacker from {raw} to {mode}")
    n = len(letters)
    if suffix.startswith("16"):
        samples = rows[:, :2 * n * count].reshape(r, count, n, 2)[..., 0 if suffix == "16B" else 1]
    else:
        samples = (_REVERSED_BITS[rows] if suffix == "R" else rows)[:, :n * count].reshape(r, count, n)
    out = np.zeros((r, count, 4), np.uint8)
    if family == "RGB":
        out[..., 3] = 255
    for i, ch in enumerate(letters):
        if ch != "X":
            out[..., slots[ch]] = samples[..., i]
    if mode == "LA":
        out[..., 1] = out[..., 2] = out[..., 0]
    if "a" in letters:
        out = _unpremultiply(out)
    return out


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

# BmpImagePlugin: bits -> (mode, raw mode) of an uncompressed file.
_BMP_BITS = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
             32: ("RGB", "BGRX")}
# (bits, masks) -> raw mode of a BI_BITFIELDS file; the 32-bit keys hold the
# alpha mask too.
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX", (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR", (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA", (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR", (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR", (16, (0xF800, 0x7E0, 0x1F)): "BGR;16", (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_COMPRESSIONS = {0: "BI_RGB", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "JPEG", 5: "PNG"}


def _check_size(path: str, w: int, h: int):
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{path}: {w}x{h} pixels exceed Pillow's decompression bomb limit")


# Image._MAPMODES: a single raw tile of one of these modes, unpacked by its
# own mode, Pillow maps straight from the file (ImageFile.load) where the
# file holds height x stride bytes from the tile's offset: its rows then
# may overlap, where the raw decoder would refuse a stride shorter than a
# row.
_MAP_MODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")


def _raw_decode(path: str, data: bytes, im: np.ndarray, mode: str, raw: str, box, offset: int, stride: int,
                orientation: int = 1, single: bool = False):
    """Pillow's raw decoder: rows of ``raw`` from ``offset`` into ``box``
    (x0, y0, x1, y1) of ``im``, each row ``stride`` bytes apart (0: just
    the row's bytes), bottom row first for orientation -1. The data must
    reach the last row's end. ``single``: the image's only tile, which
    Pillow may map from the file (see _MAP_MODES)."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    if w <= 0 or h <= 0:
        return
    need = -(-w * raw_bits(raw) // 8)
    step = stride or need
    mapped = single and raw == mode and mode in _MAP_MODES and offset + h * stride <= len(data)
    if step < need and not mapped:
        raise ValueError(f"{path}: rows of {need} bytes do not fit a stride of {stride}")
    end = offset + (h - 1) * step + need
    if mapped and len(data) < end <= -(-len(data) // 4096) * 4096:
        data = data + bytes(end - len(data))  # a mapped file's last page reads as zeros past its end
    if offset < 0 or end > len(data):
        raise ValueError(f"{path}: image file is truncated")
    buf = np.frombuffer(data, np.uint8, count=(h - 1) * step + need, offset=offset)
    rows = np.lib.stride_tricks.as_strided(buf, (h, need), (step, 1))
    pixels = unpack(mode, raw, rows, w)
    im[y0:y1, x0:x1] = pixels if orientation > 0 else pixels[::-1]


def read_bmp(path: str) -> Tuple[np.ndarray, str]:
    """A BMP as Pillow's array of it, [H,W,C], and its mode ("1", "L", "P",
    "RGB" or "RGBA"); see the module's docstring. What Pillow refuses
    (other header sizes and bit depths, JPEG or PNG inside, masks it does
    not know, palettes of no or too many colours, truncated data) raises
    ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != BMP_SIGNATURE:
        raise ValueError(f"{path}: not a BMP file")

    def u16(pos):
        return struct.unpack_from("<H", data, pos)[0]

    def u32(pos):
        return struct.unpack_from("<I", data, pos)[0]

    if len(data) < 18:
        raise ValueError(f"{path}: BMP: truncated header")
    offset, header = u32(10), u32(14)
    if len(data) < 14 + header or header < 4:
        raise ValueError(f"{path}: BMP: truncated header of {header} bytes")
    pos = 14 + header  # where Pillow's file pointer stands after the header
    direction = -1
    masks = None
    if header == 12:  # OS/2 1.x
        w, h, bits, compression, padding = u16(18), u16(20), u16(24), 0, 3
        colors = 0
    elif header in (40, 52, 56, 64, 108, 124):
        if data[25] == 0xFF:  # a negative height: rows top-down
            direction = 1
        w, h = u32(18), (u32(22) if direction < 0 else 2 ** 32 - u32(22))
        bits, compression, colors, padding = u16(28), u32(30), u32(46), 4
        if compression == 3:
            if header >= 52:
                masks = tuple(u32(54 + 4 * i) for i in range(4 if header >= 56 else 3)) + ((0,) if header < 56 else ())
            else:  # the three masks follow a 40-byte header
                if len(data) < pos + 12:
                    raise ValueError(f"{path}: BMP: truncated bitfield masks")
                masks = tuple(u32(pos + 4 * i) for i in range(3)) + (0,)
                pos += 12
    else:
        raise ValueError(f"{path}: BMP: unsupported header type ({header} bytes)")
    _check_size(path, w, h)
    colors = colors or (1 << bits)
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BITS:
        raise ValueError(f"{path}: BMP: unsupported pixel depth ({bits} bits)")
    mode, raw = _BMP_BITS[bits]
    rle = False
    if compression == 3:
        if bits == 32 and masks in [m for b, m in _BMP_MASKS if b == 32]:
            raw = _BMP_MASKS[(32, masks)]
            mode = "RGBA" if "A" in raw else mode
        elif bits in (24, 16) and (bits, masks[:3]) in _BMP_MASKS:
            raw = _BMP_MASKS[(bits, masks[:3])]
        else:
            raise ValueError(f"{path}: BMP: unsupported bitfields layout {bits} bits, masks "
                             + ", ".join(f"{m:#x}" for m in masks))
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        name = _BMP_COMPRESSIONS.get(compression, str(compression))
        raise ValueError(f"{path}: BMP: unsupported compression ({name})")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: BMP: unsupported palette size ({colors} colours)")
        palette = data[pos:pos + padding * colors]
        pos += len(palette)
        grey = (0, 255) if colors == 2 else range(colors)
        if all(palette[i * padding:i * padding + 3] == bytes([v & 255]) * 3 for i, v in enumerate(grey)):
            mode = raw = "1" if colors == 2 else "L"
    offset = offset or pos
    im = _new_image(mode, h, w)
    if rle:
        if mode not in ("L", "P"):
            raise ValueError(f"{path}: BMP: RLE{8 if compression == 1 else 4} data into a {mode} image")
        out = np.zeros(w * h, np.uint8)
        n = _lib().bmp_rle_decode(data, len(data), offset, w, w * h, int(compression == 2), out.ctypes.data,
                                  out.size) if w * h else 0
        if n == -2:
            raise ValueError(f"{path}: BMP: RLE delta cut short")
        if n < w * h:
            raise ValueError(f"{path}: BMP: not enough RLE image data")
        rows = out.reshape(h, w)
        im[:] = rows if direction > 0 else rows[::-1]
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        _raw_decode(path, data, im, mode, raw, (0, 0, w, h), offset, stride, direction, single=True)
    return _as_array(mode, im), mode


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

# Pillow's TiffImagePlugin.COMPRESSION_INFO, by what this module does with
# each: decoded here, or refused, as Pillow 12.1 with its libtiff 4.7
# refuses them (with the reason).
_TIFF_DECODED = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                 7: "JPEG", 8: "Adobe Deflate", 32771: "CCITT RLEW", 32773: "PackBits", 32809: "ThunderScan",
                 32946: "Deflate", 34925: "LZMA", 50000: "ZSTD"}
_SGILOG_REASON = ("Pillow has no mode for the LogLuv photometric interpretations (32844, 32845) and libtiff's "
                  "SGILog codec refuses any other")
_TIFF_PILLOW_REFUSES = {34676: ("SGILog", _SGILOG_REASON), 34677: ("SGILog24", _SGILOG_REASON),
                        50001: ("WebP", "Pillow's libtiff is built without its WebP codec")}
# The codings whose strips libtiff runs through its predictor
# (TIFFPredictorInit): LZW, the Deflates, LZMA and ZSTD.
_PREDICTED = (5, 8, 32946, 34925, 50000)
_FAX = (2, 3, 4, 32771)
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette", 4: "Mask", 5: "Separated (CMYK)",
                6: "YCbCr", 8: "CIELab"}


def _open_info() -> Dict[tuple, Tuple[str, str]]:
    """Pillow's TiffImagePlugin.OPEN_INFO: (byte order, photometric, sample
    formats, fill order, bits per sample, extra samples) -> (mode, raw
    mode). Rows that hold for both byte orders are written once."""
    both = [
        (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"), (1, (1,), 1, (1,), (), "1", "1"),
        (1, (1,), 2, (1,), (), "1", "1;R"), (0, (1,), 1, (2,), (), "L", "L;2I"), (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"), (0, (1,), 1, (4,), (), "L", "L;4I"),
        (0, (1,), 2, (4,), (), "L", "L;4IR"), (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
        (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"), (1, (1,), 1, (8,), (), "L", "L"),
        (1, (2,), 1, (8,), (), "L", "L"), (1, (1,), 2, (8,), (), "L", "L;R"),
        (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"), (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8,) * 4, (), "RGBA", "RGBA"), (2, (1,), 1, (8,) * 4, (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX"), (2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8,) * 4, (1,), "RGBA", "RGBa"), (2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"), (2, (1,), 1, (8,) * 4, (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"), (2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8,) * 4, (999,), "RGBA", "RGBA"),
        (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"), (3, (1,), 1, (2,), (), "P", "P;2"),
        (3, (1,), 2, (2,), (), "P", "P;2R"), (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
        (3, (1,), 1, (8,), (), "P", "P"), (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"), (3, (1,), 2, (8,), (), "P", "P;R"),
        (5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK"), (5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), (), "L", "L"), (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    table = {}
    for prefix in (b"II", b"MM"):
        for *key, mode, raw in both:
            table[(prefix, *key)] = (mode, raw)
        end = "L" if prefix == b"II" else "B"
        for photo, bits, extra, mode, raw in ((2, (16,) * 3, (), "RGB", "RGB;16"),
                                              (2, (16,) * 4, (), "RGBA", "RGBA;16"),
                                              (2, (16,) * 4, (0,), "RGB", "RGBX;16"),
                                              (2, (16,) * 4, (1,), "RGBA", "RGBa;16"),
                                              (2, (16,) * 4, (2,), "RGBA", "RGBA;16"),
                                              (5, (16,) * 4, (), "CMYK", "CMYK;16")):
            table[(prefix, photo, (1,), 1, bits, extra)] = (mode, raw + end)
    ii, mm = b"II", b"MM"
    table.update({
        (ii, 1, (1,), 1, (12,), ()): ("I;16", "I;12"), (ii, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
        (ii, 1, (1,), 1, (16,), ()): ("I;16", "I;16"), (mm, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
        (ii, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"), (ii, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
        (mm, 1, (2,), 1, (16,), ()): ("I", "I;16BS"), (ii, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
        (mm, 0, (3,), 1, (32,), ()): ("F", "F;32BF"), (ii, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
        (ii, 1, (2,), 1, (32,), ()): ("I", "I;32S"), (mm, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
        (ii, 1, (3,), 1, (32,), ()): ("F", "F;32F"), (mm, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    })
    return table


OPEN_INFO = _open_info()
_MAX_SAMPLES = max(len(key[4]) for key in OPEN_INFO)
# TIFF field types: (struct code, bytes); Pillow skips a field of another type.
_FIELD_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8), 6: ("b", 1), 7: ("s", 1),
                8: ("h", 2), 9: ("l", 4), 10: ("ll", 8), 11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8)}
# Tags read here whose value Pillow keeps as one number (TiffTags length 1);
# the others it keeps as a tuple.
_SCALAR_TAGS = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}


class TiffLayout(NamedTuple):
    """What the first directory says, as Pillow reads it."""
    order: str  # "<" or ">"
    width: int
    height: int
    mode: str
    raw: str
    compression: int
    photometric: int
    planar: int
    fill_order: int
    predictor: int
    bits: Tuple[int, ...]
    extra: Tuple[int, ...]
    orientation: int
    tiles: Optional[Tuple[int, int]]  # (width, length) of a tiled file
    rows_per_strip: int
    offsets: Tuple[int, ...]
    byte_counts: Optional[Tuple[int, ...]]
    fields: Dict[int, tuple]  # the whole directory (_tiff_fields; libtiff's reading where libtiff decodes)
    libtiff_samples: int = 0  # libtiff's SamplesPerPixel where libtiff decodes


def _tiff_fields(path: str, data: bytes, pillow: bool = True) -> Tuple[str, Dict[int, tuple], bool]:
    """(byte order, {tag: values}, whether the directory's entries all lie
    in the file) of the first directory, as Pillow's ImageFileDirectory_v2
    loads it: fields of unknown type are skipped; a field whose data lies
    past the end of the file ends the loading ("Truncated File Read"), as
    does a directory cut short, keeping the fields read before it. With
    ``pillow`` false, libtiff's reading: such a field alone is passed
    over."""
    prefix = data[:4]
    if prefix not in TIFF_SIGNATURES:
        raise ValueError(f"{path}: not a TIFF file")
    order = ">" if prefix[:2] == b"MM" else "<"
    big = prefix[2] == 43  # Pillow tests one byte: a big-endian BigTIFF reads as classic
    head = struct.unpack_from(order + ("Q" if big else "L"), data, 8 if big else 4)[0] if len(data) >= 16 else None
    if head is None and (big or len(data) < 8):
        raise ValueError(f"{path}: TIFF: truncated header")
    if head is None:
        head = struct.unpack_from(order + "L", data, 4)[0]
    if not head:
        raise ValueError(f"{path}: TIFF: no image directory")
    fields: Dict[int, tuple] = {}
    pos = head
    count_fmt, entry_fmt, inline = (("Q", "HHQ8s", 8) if big else ("H", "HHL4s", 4))
    entry_size = struct.calcsize(order + entry_fmt)
    if pos + struct.calcsize(count_fmt) > len(data):
        return order, fields, False
    (n,) = struct.unpack_from(order + count_fmt, data, pos)
    pos += struct.calcsize(count_fmt)
    for _ in range(n):
        if pos + entry_size > len(data):
            return order, fields, False
        tag, typ, count, value = struct.unpack_from(order + entry_fmt, data, pos)
        pos += entry_size
        if typ not in _FIELD_TYPES:
            continue
        code, unit = _FIELD_TYPES[typ]
        size = count * unit
        if size > inline:
            (at,) = struct.unpack_from(order + ("Q" if big else "L"), value)
            if at + size > len(data):
                if pillow:
                    return order, fields, True
                continue
            value = data[at:at + size]
        else:
            value = value[:size]
        if not value:
            continue
        if code in ("s", "B"):
            fields[tag] = (value,)  # bytes, as Pillow keeps BYTE and ASCII fields
        else:
            fields[tag] = struct.unpack(order + code * count, value)
    return order, fields, True


# libtiff's integer field types: struct code and bytes (TIFFDataWidth), and
# every type's width for the directory's byte count estimate.
_LIBTIFF_INTS = {1: ("B", 1), 6: ("b", 1), 3: ("H", 2), 8: ("h", 2), 4: ("L", 4), 9: ("l", 4), 16: ("Q", 8),
                 17: ("q", 8)}
_LIBTIFF_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8,
                  18: 8}
_LIBTIFF_NAMES = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
                  277: "SamplesPerPixel", 278: "RowsPerStrip", 280: "MinSampleValue", 281: "MaxSampleValue",
                  284: "PlanarConfiguration", 322: "TileWidth", 323: "TileLength", 338: "ExtraSamples",
                  339: "SampleFormat", 32996: "DataType", 32997: "ImageDepth", 32998: "TileDepth"}
_LIBTIFF_ERRORS = {"count": "Incorrect count for", "type": "Incompatible type for", "io": "IO error during reading of",
                   "range": "Incorrect value for", "psdif": "Cannot handle different values per sample for"}


class _EntryError(Exception):
    pass


class LibtiffDirectory(NamedTuple):
    """What libtiff's TIFFReadDirectory makes of the first directory, where
    it differs from Pillow's reading: the strips' layout."""
    planar: int
    rows_per_strip: int
    offsets: Tuple[int, ...]
    byte_counts: Tuple[int, ...]
    samples: int  # SamplesPerPixel
    fields: Dict[int, tuple]  # every field it can read (_tiff_fields(..., pillow=False))
    compression: int  # its Compression (the first of two such fields)


def libtiff_directory(path: str, data: bytes, order: str, big: bool, tiled: bool) -> LibtiffDirectory:
    """libtiff 4.7's TIFFReadDirectory over the first directory, as far as
    it can refuse a file or lay its strips out otherwise than Pillow's
    reading of the directory: the fields it fetches with no recovery
    (SamplesPerPixel, Compression, the image and tile sizes,
    PlanarConfiguration, RowsPerStrip, ExtraSamples, then BitsPerSample,
    SampleFormat and the sample value bounds) must have one value, or one
    per sample, of an integer type and in range (TIFFReadDirEntryShort,
    _Long, _PersampleShort), and TIFFSetField must take it; the strip
    arrays are cut or zero-padded to the number of strips
    (TIFFFetchStripThing), and missing byte counts estimated
    (EstimateStripByteCounts). A file libtiff refuses raises ValueError
    with libtiff's message, which Pillow reports as "decoder error -2"."""
    pointer = "Q" if big else "L"
    inline = 8 if big else 4
    head = struct.unpack_from(order + pointer, data, 8 if big else 4)[0]
    count_fmt, entry_fmt = ("Q", "HHQ8s") if big else ("H", "HHL4s")
    if head + struct.calcsize(count_fmt) > len(data):
        raise ValueError(f"{path}: TIFF: cannot read the directory count (libtiff refuses the file)")
    (n,) = struct.unpack_from(order + count_fmt, data, head)
    entry_size = struct.calcsize(order + entry_fmt)
    start = head + struct.calcsize(count_fmt)
    if start + n * entry_size > len(data):
        raise ValueError(f"{path}: TIFF: cannot read the directory (libtiff refuses the file)")
    entries = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(order + entry_fmt, data, start + i * entry_size)
        entries.setdefault(tag, (typ, count, raw))

    def ints(tag, limit=None):
        typ, count, raw = entries[tag]
        if typ not in _LIBTIFF_INTS:
            raise _EntryError("type")
        code, width = _LIBTIFF_INTS[typ]
        k = count if limit is None else min(count, limit)
        size = k * width
        if count * width <= inline:  # the entry's own count says where its values lie
            buf = raw[:size]
        else:
            (at,) = struct.unpack(order + pointer, raw)
            if at + size > len(data):
                raise _EntryError("io")
            buf = data[at:at + size]
        return struct.unpack(order + code * k, buf)

    def scalar(tag, top):  # TIFFReadDirEntryShort / _Long
        if entries[tag][1] != 1:
            raise _EntryError("count")
        v = ints(tag)[0]
        if v < 0 or v > top:
            raise _EntryError("range")
        return v

    def per_sample(tag, spp):  # TIFFReadDirEntryShort, else _PersampleShort
        try:
            return scalar(tag, 0xFFFF)
        except _EntryError as e:
            if str(e) != "count":
                raise
        if entries[tag][1] < spp:
            raise _EntryError("count")
        values = ints(tag)
        if any(v < 0 or v > 0xFFFF for v in values):
            raise _EntryError("range")
        if any(v != values[0] for v in values[:spp]):
            raise _EntryError("psdif")
        return values[0]

    def fetch(tag, read):
        try:
            return read()
        except _EntryError as e:
            raise ValueError(f"{path}: TIFF: {_LIBTIFF_ERRORS[str(e)]} \"{_LIBTIFF_NAMES[tag]}\" "
                             "(libtiff refuses the file)") from None

    def bad_value(tag, v):
        raise ValueError(f"{path}: TIFF: bad value {v} for \"{_LIBTIFF_NAMES[tag]}\" tag (libtiff refuses the file)")

    values = {}
    spp = 1
    if 277 in entries:
        spp = fetch(277, lambda: scalar(277, 0xFFFF))
        if spp == 0:
            bad_value(277, spp)
    compression = fetch(259, lambda: per_sample(259, spp)) if 259 in entries else 1
    for i in range(n):  # the first pass, in the directory's order
        tag = struct.unpack_from(order + "H", data, start + i * entry_size)[0]
        if tag in values or tag not in (256, 257, 32997, 322, 323, 32998, 284, 278, 338):
            continue
        if tag == 338:
            if entries[tag][1] > 0xFFFF:
                fetch(tag, lambda: (_ for _ in ()).throw(_EntryError("count")))
            extra = fetch(tag, lambda: ints(338))
            if any(v < 0 or v > 0xFFFF for v in extra):
                fetch(tag, lambda: (_ for _ in ()).throw(_EntryError("range")))
            if len(extra) > spp or any(v > 2 and v != 999 for v in extra):
                bad_value(tag, extra)
            values[tag] = extra
            continue
        v = fetch(tag, lambda t=tag: scalar(t, 0xFFFF if t == 284 else 0xFFFFFFFF))
        if (tag == 284 and v not in (1, 2)) or (tag == 278 and v == 0):
            bad_value(tag, v)
        values[tag] = v
    if 256 not in values and 257 not in values:
        raise ValueError(f"{path}: TIFF: missing required \"ImageLength\" field (libtiff refuses the file)")
    for tag in (280, 281, 258, 32996, 339):  # the second pass
        if tag in entries:
            v = fetch(tag, lambda t=tag: per_sample(t, spp))
            if tag == 339 and not 1 <= v <= 6:
                bad_value(tag, v)
    planar = values.get(284, 1)
    height = values.get(257, 0)
    rows = values.get(278, 0xFFFFFFFF)
    if 322 in values or 323 in values:  # libtiff's tiles, whatever Pillow makes of the file
        if not values.get(322) or not values.get(323):
            raise ValueError(f"{path}: TIFF: cannot handle zero number of tiles (libtiff refuses the file)")
        if not tiled:
            raise ValueError(f"{path}: TIFF: missing required \"TileOffsets\" field (libtiff refuses the file)")
    fields = _tiff_fields(path, data, pillow=False)[1]
    if compression == 6:
        # tif_dirread.c's OJPEG hack: a Photometric libtiff passes over (not
        # one value of an integer type) or RGB is YCbCr, and a missing
        # SamplesPerPixel is 3 for YCbCr, 1 for MinIsWhite or MinIsBlack.
        try:
            photo = scalar(262, 0xFFFF) if 262 in entries else 2
        except _EntryError:
            photo = 2
        photo = 6 if photo == 2 else photo
        fields[262] = (photo,)
        if 277 not in entries and photo == 6:
            spp = 3
        for tag in (519, 520, 521):  # the tables' offsets: libtiff passes over a field of another type
            if tag in entries and entries[tag][0] not in _LIBTIFF_INTS:
                fields.pop(tag, None)
    if tiled:
        return LibtiffDirectory(planar, rows, (), (), spp, fields, compression)
    nstrips = 1 if min(rows, height) == 0 else -(-height // min(rows, height))
    if planar == 2:
        nstrips *= spp

    def strips(tag):
        try:
            got = ints(tag, nstrips)
        except _EntryError as e:
            raise ValueError(f"{path}: TIFF: {_LIBTIFF_ERRORS[str(e)]} \"{'StripOffsets' if tag == 273 else 'StripByteCounts'}\" "
                             "(libtiff refuses the file)") from None
        if any(v < 0 for v in got):
            raise ValueError(f"{path}: TIFF: negative strip offset or byte count (libtiff refuses the file)")
        return tuple(got) + (0,) * (nstrips - len(got))

    if 273 not in entries:
        raise ValueError(f"{path}: TIFF: missing required \"StripOffsets\" field (libtiff refuses the file)")
    offsets = strips(273)
    if 279 in entries:
        counts = strips(279)
    elif (planar == 1 and nstrips > 1) or (planar == 2 and nstrips != spp):
        raise ValueError(f"{path}: TIFF: missing required \"StripByteCounts\" field (libtiff refuses the file)")
    else:  # EstimateStripByteCounts of a compressed file
        space = (16 + 8 + n * 20 + 8) if big else (8 + 2 + n * 12 + 4)
        for typ, count, _ in entries.values():
            if typ not in _LIBTIFF_WIDTH:
                raise ValueError(f"{path}: TIFF: cannot determine size of unknown tag type {typ} (libtiff refuses "
                                 "the file)")
            size = _LIBTIFF_WIDTH[typ] * count
            space += size if size > inline else 0
        space = len(data) - space if len(data) >= space else len(data)
        if planar == 2:
            space //= spp
        counts = [space] * nstrips
        last = offsets[-1]
        if last + counts[-1] > len(data):
            counts[-1] = 0 if last >= len(data) else len(data) - last
        counts = tuple(counts)
    return LibtiffDirectory(planar, rows, offsets, counts, spp, fields, compression)


def tiff_layout(path: str, data: bytes) -> TiffLayout:
    """The first directory of a TIFF file and the mode Pillow gives it
    (TiffImageFile._setup). What Pillow refuses, and what this module does
    not decode, raises ValueError naming it."""
    order, fields, complete = _tiff_fields(path, data)

    def get(tag, default=None):
        if tag not in fields:
            return default
        v = fields[tag]
        if tag == 284 and isinstance(v[0], bytes):
            return v[0]  # Pillow keeps it, and it equals neither 1 nor 2
        if any(isinstance(x, (bytes, float)) for x in v):
            raise ValueError(f"{path}: TIFF: tag {tag} holds {type(v[0]).__name__} values")
        return v[0] if tag in _SCALAR_TAGS else tuple(v)

    if 0xBC01 in fields:
        raise ValueError(f"{path}: TIFF: Windows Media Photo files are not supported")
    compression = get(259, 1)
    if compression in _TIFF_PILLOW_REFUSES:
        name, reason = _TIFF_PILLOW_REFUSES[compression]
        raise ValueError(f"{path}: TIFF: {name} compression ({compression}) is refused, as Pillow refuses it: "
                         f"{reason}")
    if compression not in _TIFF_DECODED:
        raise ValueError(f"{path}: TIFF: unknown compression ({compression})")
    planar = get(284, 1)
    # Pillow takes every old-style JPEG file as YCbCr whatever the field
    # holds (TiffImagePlugin _setup); libtiff's reading of it is
    # libtiff_directory's.
    photo = get(262, 0) if compression != 6 else 6
    key_photo = photo
    fill_order = get(266, 1)
    if 256 not in fields or 257 not in fields:
        raise ValueError(f"{path}: TIFF: missing dimensions")
    w, h = get(256), get(257)
    _check_size(path, w, h)
    sample_format = get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bits = get(258, (1,))
    extra = get(338, ())
    spp = get(277, 3 if compression == 6 else 1)
    if spp > _MAX_SAMPLES:
        raise ValueError(f"{path}: TIFF: invalid value for samples per pixel ({spp})")
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError(f"{path}: TIFF: unknown data organization ({len(bits)} bit depths, {spp} samples per pixel)")
    prefix = b"MM" if order == ">" else b"II"
    key = (prefix, key_photo, sample_format, fill_order, bits, extra)
    if key not in OPEN_INFO:
        raise ValueError(f"{path}: TIFF: unknown pixel mode (photometric {_PHOTOMETRIC.get(key_photo, key_photo)}, "
                         f"sample format {sample_format}, fill order {fill_order}, bits {bits}, extra samples "
                         f"{extra})")
    mode, raw = OPEN_INFO[key]
    classic = b"\x2a\x00" if prefix == b"II" else b"\x00\x2a"
    if compression != 1 and data[2:4] != classic and data[2] != 43:  # Pillow reads it, libtiff does not
        raise ValueError(f"{path}: TIFF: bad version number {data[2:4].hex()} (libtiff refuses a compressed file)")
    if compression != 1 and not complete:  # Pillow keeps what it read of the directory, libtiff fails
        raise ValueError(f"{path}: TIFF: the directory ends past the end of the file (libtiff cannot read it)")
    if compression != 1:  # libtiff's engine
        if fill_order == 2:
            mode, raw = OPEN_INFO[(prefix, key_photo, sample_format, 1, bits, extra)]
        if photo == 6 and compression == 7 and planar == 1:  # libjpeg converts YCbCr to RGB
            raw = "RGB"
        elif raw == "I;16":
            raw = "I;16N"
        elif raw.endswith((";16B", ";16L")):
            raw = raw[:-1] + "N"
    tiled = 324 in fields
    libtiff = None
    if compression != 1:  # libtiff reads the directory again, its own way
        libtiff = libtiff_directory(path, data, order, data[2] == 43, tiled and 273 not in fields)
        if libtiff.compression != compression:
            raise ValueError(f"{path}: TIFF: libtiff decodes compression {libtiff.compression} where Pillow reads "
                             f"{compression} (two Compression fields): not mirrored")
    if 273 not in fields and not tiled and libtiff is None:
        raise ValueError(f"{path}: TIFF: unknown data organization (no strip or tile offsets)")
    if mode in ("P", "PA") and 320 not in fields:
        raise ValueError(f"{path}: TIFF: palette image without a colour map")
    tiles = None
    if tiled and 273 not in fields:
        tiles = (get(322), get(323))
        if not isinstance(tiles[0], int) or not isinstance(tiles[1], int):
            raise ValueError(f"{path}: TIFF: invalid tile dimensions")
    if libtiff is not None and not tiles:
        # libtiff decodes by its own reading of the fields it uses (a field
        # Pillow's loading stopped short of among them), one value each.
        def lget(tag, default):
            v = libtiff.fields.get(tag)
            if v is None or len(v) != 1:
                return default
            return v[0][0] if isinstance(v[0], bytes) and len(v[0]) == 1 else (
                default if isinstance(v[0], (bytes, float)) else v[0])

        if 262 in libtiff.fields:
            photo = lget(262, photo)
        return TiffLayout(order, w, h, mode, raw, compression, photo, libtiff.planar, lget(266, 1), lget(317, 1),
                          bits, extra, get(274, 1) or 1, None, libtiff.rows_per_strip, libtiff.offsets,
                          libtiff.byte_counts, libtiff.fields, libtiff.samples)
    offsets = get(325 if tiles else 279)
    return TiffLayout(order, w, h, mode, raw, compression, photo, planar, fill_order, get(317, 1), bits,
                      extra, get(274, 1) or 1, tiles, get(278, h), get(324 if tiles else 273), offsets, fields)


def _pillow_raw_tiles(path: str, data: bytes, lay: TiffLayout) -> np.ndarray:
    """An uncompressed file through Pillow's own tile list and raw decoder
    (TiffImageFile._setup, ImageFile.load): each strip or tile read from
    its offset with no regard for its byte count; a plane of a planar file
    unpacked by the letter of the raw mode at that plane's index; the last
    offset alone where one tile covers the image."""
    im = _new_image(lay.mode, lay.height, lay.width)
    w, h = lay.tiles or (lay.width, lay.rows_per_strip)
    offsets = lay.offsets
    if w == lay.width and h == lay.height and lay.planar != 2:
        offsets = offsets[-1:]
    bps_count = {2: 3, 6: 3, 8: 3, 5: 4}.get(lay.photometric, 1) + len(lay.extra)
    tiles = []
    x = y = layer = 0
    for offset in offsets:
        stride = w * sum(lay.bits) / 8 if x + w > lay.width else 0
        raw = lay.raw
        if lay.planar == 2:
            if layer >= len(lay.raw):
                raise ValueError(f"{path}: TIFF: plane {layer} has no letter in raw mode {lay.raw}")
            raw = lay.raw[layer]
            stride /= bps_count
        tiles.append((offset, (x, y, min(x + w, lay.width), min(y + h, lay.height)), raw, int(stride)))
        x += w
        if x >= lay.width:
            x, y = 0, y + h
            if y >= lay.height:
                y = 0
                layer += 1
    tiles.sort(key=lambda t: t[0])
    if len(tiles) == 1 and tiles[0][2] == lay.mode in _MAP_MODES and lay.orientation in (5, 6, 7, 8):
        # Pillow maps the tile at the image's size, which the orientation
        # has swapped, then transposes what it mapped.
        offset, _, raw, stride = tiles[0]
        if offset + lay.width * stride <= len(data):
            swapped = _new_image(lay.mode, lay.width, lay.height)
            _raw_decode(path, data, swapped, lay.mode, raw, (0, 0, lay.height, lay.width), offset, stride, single=True)
            return swapped
    for offset, box, raw, stride in tiles:
        if lay.planar == 2 and raw not in _PLANE_LETTERS.get(lay.mode, ""):
            raise ValueError(f"{path}: TIFF: no unpacker from {raw} to {lay.mode} (a plane of planar configuration 2)")
        if lay.planar == 2 and im.ndim == 3:
            _plane_decode(path, data, im, lay.mode, raw, box, offset, stride)
        else:
            _raw_decode(path, data, im, lay.mode, raw, box, offset, stride, single=len(tiles) == 1)
    return im


# The one-band unpackers Pillow has, by mode: what a plane of an
# uncompressed planar file can be read by.
_PLANE_LETTERS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB", "L": "L", "P": "LP", "I": "I", "F": "F"}


def _plane_decode(path, data, im, mode, letter, box, offset, stride):
    """Pillow's one-band unpacker (a plane of a planar file) into one byte of
    a four-byte pixel; CIELab's a and b planes turn unsigned."""
    slot = _SLOTS[_family(mode)][letter]
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    step = stride or w
    end = offset + (h - 1) * step + w
    if end > len(data):
        raise ValueError(f"{path}: image file is truncated")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, count=end - offset, offset=offset), (h, w),
                                           (step, 1))
    im[y0:y1, x0:x1, slot] = rows ^ 128 if mode == "LAB" and letter in "AB" else rows


def chunk_bytes(path: str, data: bytes, lay: TiffLayout, index: int, what: str) -> Tuple[bytes, int]:
    """(the bytes, their file offset) of strip or tile ``index``, as
    libtiff's TIFFFillStrip and TIFFFillTile read them: a missing offset, a
    byte count of 0 or one past the end of the file raises."""
    if lay.byte_counts is None:
        raise ValueError(f"{path}: TIFF: missing required StripByteCounts")
    if index >= len(lay.offsets) or index >= len(lay.byte_counts):
        raise ValueError(f"{path}: TIFF: no offset for {what}")
    start, count = lay.offsets[index], lay.byte_counts[index]
    if count == 0:
        raise ValueError(f"{path}: TIFF: invalid byte count 0 for {what}")
    if count > len(data) or start > len(data) - count:
        raise ValueError(f"{path}: TIFF: read error on {what} (it ends past the end of the file)")
    return data[start:start + count], start


def _decompress(path: str, lay: TiffLayout, chunk: bytes, start: int, width: int, rows: int, size: int,
                what: str, partial_ok: bool = False, previous: Optional[np.ndarray] = None,
                fax_mode: Optional[dict] = None) -> np.ndarray:
    """One strip or tile decoded as libtiff's TIFFReadEncodedStrip and
    TIFFReadTile decode it: bits reversed first for fill order 2 (libtiff's
    JPEG codec reads the bytes as stored), then decoded to ``size`` bytes
    (``rows`` rows of ``width`` pixels); a libtiff error raises. Group 3
    or 4 data that ends in its last row takes that row as libtiff fills it;
    in an earlier row, the rows after it keep what Pillow's strip buffer
    held, ``previous`` (the strip decoded before it), and where there is
    none (the first strip) it raises, naming those rows undefined. Group 3
    data that ends where libtiff 4.7 looks for an EOL is decoded again from
    the strip's start without EOLs, for that strip and the strips after it.
    ``fax_mode`` is the CCITT codec's state the caller keeps for the file
    (a dict): that mode and libtiff's run arrays, which a strip's first row
    can read past its white reference line. With ``partial_ok`` (a
    caller that goes on past a failed strip, as TIFFRGBAImage does), data
    that runs short and an LZW, ZSTD, Deflate or LZMA error give what was
    decoded before it, zeros after it (Deflate and LZMA through
    utils/stream_codecs.py, as libtiff decodes them through zlib and
    liblzma)."""
    c = lay.compression
    if lay.fill_order == 2 and c != 7:
        chunk = _REVERSED_BITS[np.frombuffer(chunk, np.uint8)].tobytes()
    out = np.zeros(size, np.uint8)
    if c in (8, 32946, 34925):
        n, error = (stream_codecs.unxz_into if c == 34925 else stream_codecs.inflate_into)(chunk, out)
        if error is not None and not partial_ok:
            raise ValueError(f"{path}: TIFF: {_TIFF_DECODED[c]} error in {what}: {error}")
        return out  # libtiff keeps what was written before the error
    elif c == 50000:
        from mlinerf_tpu_torch.utils import zstd

        try:
            n = zstd.decode_into(path, chunk, out, what)
        except ValueError:
            if not partial_ok:
                raise
            return out  # libtiff zeroes what follows the bytes flushed before the error
    elif c == 5:
        n = _lib().lzw_decode(chunk, len(chunk), out.ctypes.data, size)
        if n < 0 and not partial_ok:
            raise ValueError(f"{path}: TIFF: corrupted LZW table in {what}")
    elif c == 32773:
        n = _lib().packbits_decode(chunk, len(chunk), out.ctypes.data, size)
    elif c in _FAX:
        if lay.bits[0] != 1:
            raise ValueError(f"{path}: TIFF: {_TIFF_DECODED[c]} with {lay.bits[0]}-bit samples (libtiff's CCITT "
                             "codecs take 1 bit per sample)")
        two_d = c == 3 and bool(lay.fields.get(292, (0,))[0] & 1)
        state = {} if fax_mode is None else fax_mode
        mode = state.setdefault("noeol", np.zeros(1, np.int64))
        nruns = (width + 32) // 32 * 32 * (2 if c == 4 or two_d else 1)
        runs = state.setdefault(("runs", nruns), np.zeros(2 * nruns, np.uint32))
        status = _lib().fax_decode(chunk, len(chunk), start, c, int(two_d), width, rows, out.ctypes.data,
                                   mode.ctypes.data, runs.ctypes.data, runs.size)
        ended = -2 - status  # the row in which the data ended (or met an EOFB)
        if 0 < ended < rows - 1 and previous is not None:
            row = -(-width // 8)
            out[(ended + 1) * row:] = previous[(ended + 1) * row:size]
            return out
        if 0 < ended < rows - 1:
            raise ValueError(f"{path}: TIFF: {_TIFF_DECODED[c]} data of {what} ends in row {ended} of {rows}: libtiff "
                             "takes the strip and leaves the rows after it undefined (Pillow's are what its buffer "
                             "held)")
        if ended == rows - 1 and rows > 1:
            return out  # libtiff fills the row it ended in and takes the strip
        if status != 1:
            raise ValueError(f"{path}: TIFF: {_TIFF_DECODED[c]} error in {what} (a row cut short or a run buffer "
                             "overflow)")
        return out
    elif c == 32809:
        if lay.bits[0] != 4:
            raise ValueError(f"{path}: TIFF: ThunderScan with {lay.bits[0]}-bit samples (libtiff's decoder takes 4)")
        if not _lib().thunder_decode(chunk, len(chunk), width, rows, out.ctypes.data):
            raise ValueError(f"{path}: TIFF: ThunderScan error in {what} (not enough or too much data for a row)")
        return out
    else:
        raise ValueError(f"{path}: TIFF: no decoder for compression {c}")
    if n < size and not partial_ok:
        raise ValueError(f"{path}: TIFF: not enough data in {what} ({n} of {size} bytes)")
    return out


# JPEG markers a tables-only stream may not hold (libtiff: "Bogus JPEGTables
# field"): SOF0-15 but DHT, JPG and DAC, and SOS.
_JPEG_FRAME_MARKERS = {m for m in range(0xC0, 0xD0) if m not in (0xC4, 0xC8, 0xCC)} | {0xDA}


def jpeg_tables(path: str, lay: TiffLayout) -> bytes:
    """The JPEGTables field (347) as a tables-only stream, SOI ... EOI; b""
    when there is none. A field that is not one raises, as in libtiff."""
    if 347 not in lay.fields:
        return b""
    tables = lay.fields[347][0] if isinstance(lay.fields[347][0], bytes) else bytes(lay.fields[347])
    if tables[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: TIFF: bogus JPEGTables field (no SOI)")
    pos = 2
    while pos + 2 <= len(tables):
        if tables[pos] != 0xFF:
            pos += 1
            continue
        marker = tables[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            return tables[:pos + 2]
        if marker in _JPEG_FRAME_MARKERS:
            raise ValueError(f"{path}: TIFF: bogus JPEGTables field (a frame or scan header)")
        if pos + 4 > len(tables):
            break
        pos += 2 + struct.unpack_from(">H", tables, pos + 2)[0]
    return tables[:pos] + b"\xff\xd9"  # libjpeg inserts the missing EOI


def jpeg_frame(path: str, tables: bytes, chunk: bytes, what: str) -> np.ndarray:
    """(H, W, C, then each component's h and v sampling factors) of a JPEG
    strip or tile."""
    from mlinerf_tpu_torch.utils.image_io import _jpeg_lib

    dims = np.zeros(11, np.int64)
    err = ctypes.create_string_buffer(256)
    if _jpeg_lib().jpeg_tiff_decode(tables, len(tables), chunk, len(chunk), 1, None, 0, dims.ctypes.data, err,
                                    len(err)) != 0:
        raise ValueError(f"{path}: TIFF: JPEG error in {what}: {err.value.decode()}")
    return dims


def ycbcr_subsampling(path: str, data: bytes, lay: TiffLayout) -> Tuple[int, int]:
    """YCbCrSubsampling (530) as libtiff takes it: the tag, else (2, 2);
    a JPEG-compressed contiguous YCbCr file without the tag takes the
    first strip's luma sampling factors (tif_jpeg.c JPEGFixupTags), an
    old-style JPEG file its frame's where its data has one (tif_ojpeg.c
    OJPEGSubsamplingCorrect)."""
    if lay.compression == 6:
        sampling = ojpeg_sampling(path, data, lay)
        if sampling:
            return sampling
    if 530 in lay.fields and len(lay.fields[530]) >= 2:
        if lay.compression == 6:  # tif_ojpeg.c keeps the tag's values as bytes
            return tuple(int(v) & 0xFF for v in lay.fields[530][:2])
        return tuple(int(v) for v in lay.fields[530][:2])
    if lay.compression == 7 and lay.planar == 1 and len(lay.bits) == 3:
        try:
            dims = jpeg_frame(path, jpeg_tables(path, lay), chunk_bytes(path, data, lay, 0, "strip 0")[0], "strip 0")
            if dims[3] in (1, 2, 4) and dims[4] in (1, 2, 4):
                return int(dims[3]), int(dims[4])
        except ValueError:
            pass
    return 2, 2


def _jpeg_decode(path: str, data: bytes, lay: TiffLayout, chunk: bytes, seg_w: int, seg_h: int, rows: int,
                 last_strip: bool, plane_spp: int, what: str) -> np.ndarray:
    """A JPEG strip or tile as tif_jpeg.c's JPEGPreDecode and JPEGDecode
    read it: its frame checked against the segment (size, component count,
    precision, sampling factors: the luma's those of YCbCrSubsampling in a
    YCbCr file, every other 1x1), then ``rows`` rows of ``seg_w`` pixels,
    YCbCr converted to RGB when the file is YCbCr in one plane. A frame
    smaller than its segment raises (libtiff warns and leaves the rest of
    its buffer as it was)."""
    from mlinerf_tpu_torch.utils.image_io import _jpeg_lib

    tables = jpeg_tables(path, lay)
    dims = jpeg_frame(path, tables, chunk, what)
    h, w, nc = (int(v) for v in dims[:3])
    if lay.bits[0] != 8:
        raise ValueError(f"{path}: TIFF: improper JPEG data precision in {what} (8-bit JPEG, {lay.bits[0]}-bit "
                         "samples)")
    if nc != plane_spp:
        raise ValueError(f"{path}: TIFF: improper JPEG component count in {what} ({nc}, expected {plane_spp})")
    ycc = lay.photometric == 6 and lay.planar == 1
    hs, vs = ycbcr_subsampling(path, data, lay) if ycc else (1, 1)
    sampling = [tuple(int(v) for v in dims[3 + 2 * c:5 + 2 * c]) for c in range(nc)]
    if sampling[0] != (hs, vs) or any(f != (1, 1) for f in sampling[1:]):
        raise ValueError(f"{path}: TIFF: improper JPEG sampling factors {sampling} in {what} (expected {hs},{vs} "
                         "for the first component and 1,1 for the others)")
    if w < seg_w or h < seg_h:
        raise ValueError(f"{path}: TIFF: JPEG {what} of {w}x{h} is smaller than its {seg_w}x{seg_h} segment "
                         "(libtiff leaves the rest undefined)")
    if (w > seg_w or h > seg_h) and not (w == seg_w and last_strip):
        raise ValueError(f"{path}: TIFF: JPEG {what} of {w}x{h} exceeds its {seg_w}x{seg_h} segment")
    out = np.empty((h, w, nc), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _jpeg_lib().jpeg_tiff_decode(tables, len(tables), chunk, len(chunk), 2 if ycc else 1, out.ctypes.data,
                                    out.size, dims.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{path}: TIFF: JPEG error in {what}: {err.value.decode()}")
    return np.ascontiguousarray(out[:rows]).reshape(-1)


# ---------------------------------------------------------------------------
# Old-style JPEG (compression 6): libtiff's tif_ojpeg.c
# ---------------------------------------------------------------------------

_JPEG_SOF = (0xC0, 0xC1, 0xC3)  # the frames tif_ojpeg.c reads in a stream


def _ojpeg_in_buffer(lay: TiffLayout, data: bytes) -> Tuple[bytes, List[int]]:
    """(the bytes tif_ojpeg.c reads, where each strip after the first
    starts in them): the JPEGInterchangeFormat's bytes, then each strip's
    (OJPEGReadBufferFill; a strip at offset 0 or past the file is skipped,
    restart marker and all, a byte count of 0 or past the file runs to its
    end). The strips are
    the ones the image's length and RowsPerStrip make, as libtiff counts
    them, whatever the StripOffsets' count."""
    fmt, fmt_len = lay.fields.get(513, (0,))[0], lay.fields.get(514, (0,))[0]
    if not isinstance(fmt, int) or fmt >= len(data):
        fmt = fmt_len = 0
    elif not isinstance(fmt_len, int) or fmt_len == 0 or fmt + fmt_len > len(data):
        fmt_len = len(data) - fmt
    parts, starts = [data[fmt:fmt + fmt_len] if fmt else b""], []
    at = len(parts[0])
    counts = lay.byte_counts or (0,) * len(lay.offsets)
    rps = min(lay.rows_per_strip, lay.height) or 1
    for i, pos in enumerate(lay.offsets[:-(-lay.height // rps)]):
        if not 0 < pos < len(data):
            continue  # skipped: the next strip's bytes follow with no restart marker between
        count = counts[i] if i < len(counts) else 0
        chunk = data[pos:] if count == 0 else data[pos:pos + count]
        if len(parts) > 1:
            starts.append(at)
        parts.append(chunk)
        at += len(chunk)
    return b"".join(parts), starts


def _ojpeg_markers(path: str, buf: bytes) -> Tuple[List[Tuple[int, bytes, bytes]], int]:
    """([(marker, segment, body)] of the markers OJPEGReadHeaderInfoSec reads
    from the start of its data up to SOS, APPn and COM skipped; the position
    after them). Data that starts with no marker (the tables form) has
    none."""
    out, pos = [], 0
    while pos < len(buf) and buf[pos] == 0xFF:
        pos += 1
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1
        if pos >= len(buf):
            raise ValueError(f"{path}: TIFF: old-style JPEG: the data ends inside a marker")
        m = buf[pos]
        pos += 1
        if m == 0xD8:
            continue
        if m not in (0xDD, 0xDB, 0xC4, 0xDA, 0xFE, *_JPEG_SOF, *range(0xE0, 0xF0)):
            raise ValueError(f"{path}: TIFF: old-style JPEG: unknown marker type {m} in JPEG data")
        if pos + 2 > len(buf):
            raise ValueError(f"{path}: TIFF: old-style JPEG: the data ends inside a marker segment")
        n = struct.unpack_from(">H", buf, pos)[0]
        body = buf[pos + 2:pos + n]
        if n < 2 or len(body) < n - 2:
            raise ValueError(f"{path}: TIFF: old-style JPEG: corrupt JPEG data")
        pos += n
        if m != 0xFE and not 0xE0 <= m <= 0xEF:
            out.append((m, bytes([0xFF, m]) + buf[pos - n:pos], body))
        if m == 0xDA:
            break
    return out, pos


def ojpeg_sampling(path: str, data: bytes, lay: TiffLayout) -> Optional[Tuple[int, int]]:
    """The luma's sampling factors in the frame of the stream's markers, the
    ones OJPEGSubsamplingCorrect takes over YCbCrSubsampling; None without
    a frame (the tables form) or with factors TIFF has no subsampling for."""
    markers, _ = _ojpeg_markers(path, _ojpeg_in_buffer(lay, data)[0])
    for m, _, body in markers:
        if m in _JPEG_SOF and len(body) >= 8:
            hv = body[7]
            if hv in (0x11, 0x12, 0x14, 0x21, 0x22, 0x24, 0x41, 0x42, 0x44):
                return hv >> 4, hv & 15
            return None
    return None


def _ojpeg_table(path: str, data: bytes, lay: TiffLayout, tag: int, name: str, huffman: bool):
    """(bodies, the table of each component) of JPEGQTables (519: 64 bytes
    each) or JPEGDCTables / JPEGACTables (520, 521: 16 counts, then the
    values) as OJPEGReadHeaderInfoSecTables* reads them: a component whose
    offset is 0 or its predecessor's shares its predecessor's table."""
    offsets = lay.fields.get(tag)
    if not offsets or not offsets[0]:
        raise ValueError(f"{path}: TIFF: old-style JPEG: missing JPEG tables (no {name})")
    spp = len(lay.bits)
    offsets = list(offsets) + [0] * max(0, spp - len(offsets))
    bodies, ids = {}, []
    for m in range(spp):
        o = offsets[m]
        if not isinstance(o, int) or not o or (m and o == offsets[m - 1]):
            ids.append(ids[m - 1])
            continue
        if any(o == offsets[n] for n in range(m - 1)):
            raise ValueError(f"{path}: TIFF: old-style JPEG: corrupt {name} tag value")
        if huffman:
            counts = data[o:o + 16]
            body = data[o:o + 16 + sum(counts)]
            if len(counts) < 16 or len(body) < 16 + sum(counts):
                raise ValueError(f"{path}: TIFF: old-style JPEG: {name} runs past the end of the file")
        else:
            body = data[o:o + 64]
            if len(body) < 64:
                raise ValueError(f"{path}: TIFF: old-style JPEG: {name} runs past the end of the file")
        bodies[m] = body
        ids.append(m)
    return bodies, ids


def ojpeg_stream(path: str, data: bytes, lay: TiffLayout) -> bytes:
    """The JPEG stream tif_ojpeg.c hands libjpeg for a stripped file: the
    tables and frame from the JPEGInterchangeFormat's markers or, where the
    data holds none, from the JPEGQTables, DC and AC tables and
    JPEGRestartInterval with a frame of the image's size and the
    YCbCrSubsampling (OJPEGReadHeaderInfoSec); then the entropy-coded data
    with an RST marker between strips, and EOI (OJPEGWriteStream)."""
    spp = len(lay.bits)
    if lay.tiles:
        raise ValueError(f"{path}: TIFF: old-style JPEG in tiles is not ported yet")
    if lay.planar == 2 and spp > 1:
        raise ValueError(f"{path}: TIFF: old-style JPEG in planar configuration 2 is not ported yet")
    if lay.bits[0] != 8:
        raise ValueError(f"{path}: TIFF: old-style JPEG with {lay.bits[0]}-bit samples (libtiff takes 8)")
    rps = min(lay.rows_per_strip, lay.height)
    ycc = lay.photometric == 6 and spp == 3
    hs, vs = ycbcr_subsampling(path, data, lay) if ycc else (1, 1)
    if rps < lay.height and rps % (8 * vs):
        raise ValueError(f"{path}: TIFF: old-style JPEG: incompatible vertical subsampling and image strip length")
    buf, starts = _ojpeg_in_buffer(lay, data)
    restart = lay.fields.get(515, (0,))[0]
    if rps < lay.height:  # OJPEGReadHeaderInfo: a restart interval of a strip, whatever the field says
        restart = (-(-lay.width // (8 * hs)) * (rps // (8 * vs))) & 0xFFFF
    segments, sof, sos = [], None, None
    markers, pos = _ojpeg_markers(path, buf)
    for m, segment, body in markers:
        if m == 0xDD:
            restart = struct.unpack_from(">H", body)[0] if len(body) >= 2 else restart
        elif m in (0xDB, 0xC4):
            segments.append(segment)
        elif m in _JPEG_SOF:
            if m == 0xC3:
                raise ValueError(f"{path}: TIFF: old-style JPEG: a lossless frame (SOF3; libjpeg gives no raw data "
                                 "of it)")
            _ojpeg_sof(path, lay, body, spp, (hs, vs) if ycc else (1, 1))
            sof = segment
        elif m == 0xDA:
            sos = segment
    if sos is None:  # the tables form: a baseline frame whatever JPEGProc says
        q, qid = _ojpeg_table(path, data, lay, 519, "JPEGQTables", False)
        dc, dcid = _ojpeg_table(path, data, lay, 520, "JPEGDCTables", True)
        ac, acid = _ojpeg_table(path, data, lay, 521, "JPEGACTables", True)
        segments = ([b"\xff\xdb" + (67).to_bytes(2, "big") + bytes([m]) + body for m, body in q.items()]
                    + [b"\xff\xc4" + (3 + len(body)).to_bytes(2, "big") + bytes([m]) + body for m, body in dc.items()]
                    + [b"\xff\xc4" + (3 + len(body)).to_bytes(2, "big") + bytes([16 | m]) + body
                       for m, body in ac.items()])
        if lay.width > 0xFFFF or lay.height > 0xFFFF:
            raise ValueError(f"{path}: TIFF: old-style JPEG of {lay.width}x{lay.height} (a JPEG frame holds at most "
                             "65535 each way; libtiff fails the strip)")
        frame = bytes([8]) + lay.height.to_bytes(2, "big") + lay.width.to_bytes(2, "big") + bytes([spp])
        frame += b"".join(bytes([c, (hs << 4) | vs if c == 0 else 0x11, qid[c]]) for c in range(spp))
        sof = b"\xff\xc0" + (8 + 3 * spp).to_bytes(2, "big") + frame
        scan = bytes([spp]) + b"".join(bytes([c, (dcid[c] << 4) | acid[c]]) for c in range(spp)) + bytes([0, 63, 0])
        sos = b"\xff\xda" + (6 + 2 * spp).to_bytes(2, "big") + scan
    elif sof is None:
        raise ValueError(f"{path}: TIFF: old-style JPEG: no frame header (SOF) before SOS")
    dri = b"\xff\xdd\x00\x04" + int(restart).to_bytes(2, "big") if restart else b""
    entropy, last = [], pos
    for k, start in enumerate(s for s in starts if s >= pos):
        entropy += [buf[last:start], bytes([0xFF, 0xD0 + k % 8])]
        last = start
    entropy.append(buf[last:])
    return b"\xff\xd8" + b"".join(segments) + dri + sof + sos + b"".join(entropy) + b"\xff\xd9"


def _ojpeg_sof(path, lay, body, spp, sampling):
    """The checks OJPEGReadHeaderInfoSecStreamSof makes of a stream's frame."""
    if len(body) < 6 + 3 * spp:
        raise ValueError(f"{path}: TIFF: old-style JPEG: corrupt SOF marker")
    precision, height, width, nc = body[0], *struct.unpack_from(">HH", body, 1), body[5]
    if precision != 8:
        raise ValueError(f"{path}: TIFF: old-style JPEG: {precision}-bit JPEG data (libtiff takes 8)")
    if height < lay.height:
        raise ValueError(f"{path}: TIFF: old-style JPEG: JPEG compressed data indicates unexpected height")
    if width != lay.width:
        raise ValueError(f"{path}: TIFF: old-style JPEG: JPEG compressed data indicates unexpected width")
    if nc != spp:
        raise ValueError(f"{path}: TIFF: old-style JPEG: JPEG compressed data indicates unexpected number of samples")
    factors = [body[7 + 3 * c] for c in range(nc)]
    if factors[0] != (sampling[0] << 4) | sampling[1] or any(f != 0x11 for f in factors[1:]):
        raise ValueError(f"{path}: TIFF: old-style JPEG: sampling factors {[hex(f) for f in factors]} other than "
                         f"{sampling[0]}x{sampling[1]} for the luma and 1x1 for the chroma are not ported yet")


def ojpeg_samples(path: str, data: bytes, lay: TiffLayout) -> List[np.ndarray]:
    """libjpeg's raw output of :func:`ojpeg_stream` (raw_data_out: no
    upsampling, no colour conversion; tif_ojpeg.c asks for it whatever the
    component count): each component's plane, in whole blocks."""
    from mlinerf_tpu_torch.utils.image_io import _jpeg_lib

    stream = ojpeg_stream(path, data, lay)
    lib = _jpeg_lib()
    dims = np.zeros(3 + 4 * 4 + 1, np.int64)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_raw_decode(stream, len(stream), None, 0, dims.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{path}: TIFF: old-style JPEG: {err.value.decode()}")
    sizes = [(int(dims[6 + 4 * c]), int(dims[5 + 4 * c])) for c in range(int(dims[2]))]
    out = np.empty(sum(h * w for h, w in sizes), np.uint8)
    if lib.jpeg_raw_decode(stream, len(stream), out.ctypes.data, out.size, dims.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{path}: TIFF: old-style JPEG: {err.value.decode()}")
    planes, at = [], 0
    failed = int(dims[3 + 4 * int(dims[2])])
    if failed >= 0:
        # tif_ojpeg.c's source could not find a restart marker ("Unexpected
        # error"): TIFFRGBAImage converts the zeroed buffer of the strip it
        # was reading, and libtiff then fails the strip after it, if any.
        rps = min(lay.rows_per_strip, lay.height)
        strip = failed * 8 * int(dims[4]) // rps
        failed = strip * rps // (8 * int(dims[4]))  # that strip's first iMCU row
        if strip < (lay.height - 1) // rps:
            raise ValueError(f"{path}: TIFF: old-style JPEG: strip {strip} lacks its restart marker (libtiff's "
                             "source cannot resynchronise: \"Unexpected error\"), and libtiff fails the strip after "
                             "it")
    for c, (h, w) in enumerate(sizes):
        planes.append(out[at:at + h * w].reshape(h, w))
        if failed >= 0:
            planes[-1][failed * 8 * int(dims[4 + 4 * c]):] = 0
        at += h * w
    return planes


def ojpeg_blocks(path: str, data: bytes, lay: TiffLayout, hs: int, vs: int) -> np.ndarray:
    """The whole image as OJPEGDecodeRaw packs libjpeg's raw YCbCr for
    TIFFRGBAImage: per block of hs x vs luma samples (the samples past the
    image's edge as the IDCT left them), then the block's Cb and Cr; block
    rows of ceil(W / hs) blocks, one after another. TIFFRGBAImage's
    TIFFYCbCrToRGB (utils/tiff_rgba.py) then does the colour work, not
    libjpeg."""
    planes = ojpeg_samples(path, data, lay)
    rows, across = -(-lay.height // vs), -(-lay.width // hs)
    y = planes[0][:rows * vs, :across * hs].reshape(rows, vs, across, hs).transpose(0, 2, 1, 3)
    out = np.concatenate([y.reshape(rows, across, hs * vs), planes[1][:rows, :across, None],
                          planes[2][:rows, :across, None]], -1)
    return out.reshape(-1)


def _libtiff_rows(path: str, lay: TiffLayout, buf: np.ndarray, rows: int, row_bytes: int, samples: int):
    """Swab to the host's order and undo the predictor (LZW and Deflate:
    libtiff's PackBits has none) in a decoded chunk, in place."""
    size = lay.bits[0] // 8
    predictor = lay.predictor if lay.compression in _PREDICTED else 1
    if predictor not in (1, 2, 3):  # PredictorSetup fails the decoder's setup
        raise ValueError(f"{path}: TIFF: \"Predictor\" value {predictor} not supported (libtiff fails the strip)")
    if predictor == 3:  # libtiff's floating point predictor leaves the samples in the host's order itself
        if not lay.raw.startswith("F;"):
            raise ValueError(f"{path}: TIFF: floating point predictor with integer samples")
        if _lib().predictor_undo(buf.ctypes.data, rows, row_bytes, samples, size, 3) != 0:
            raise ValueError(f"{path}: TIFF: floating point predictor with {lay.bits[0]}-bit samples")
        return
    if lay.order == ">" and lay.bits[0] in (16, 32, 64):
        buf.view(f"<u{size}")[:] = buf.view(f">u{size}")
    if predictor == 2:
        if lay.bits[0] not in (8, 16, 32, 64):
            raise ValueError(f"{path}: TIFF: horizontal differencing predictor with {lay.bits[0]}-bit samples")
        if _lib().predictor_undo(buf.ctypes.data, rows, row_bytes, samples, size, 2) != 0:
            raise ValueError(f"{path}: TIFF: predictor rows of {row_bytes} bytes")


def _libtiff_decode(path: str, data: bytes, lay: TiffLayout, im: np.ndarray):
    """A compressed file the way Pillow's libtiff decoder fills its image
    (TiffDecode.c _decodeStrip/_decodeTile): each strip or tile decoded by
    libtiff, then its rows unpacked by the raw mode, or for a planar file
    each plane copied into its byte of the pixel."""
    spp = len(lay.bits)
    if lay.byte_counts is None:
        raise ValueError(f"{path}: TIFF: missing required StripByteCounts")
    if any(b != lay.bits[0] for b in lay.bits):
        raise ValueError(f"{path}: TIFF: samples of different bit depths {lay.bits}")
    separate = lay.planar == 2 and spp > 1
    planes = spp if separate else 1
    plane_spp = 1 if separate else spp
    # Pillow's planar decoder copies planes into the bytes of four-byte
    # pixels: in strips it fails where the file has more planes than the
    # mode has bands, in tiles it drops the planes past the fourth.
    if separate and (lay.mode not in _BANDS or lay.bits[0] not in (8, 16)
                     or (not lay.tiles and spp > len(_BANDS[lay.mode]))):
        raise ValueError(f"{path}: TIFF: planar configuration 2 with {spp} samples of {lay.bits[0]} bits in "
                         f"{'tiles' if lay.tiles else 'strips'} into mode {lay.mode} (Pillow's decoder fails on it)")
    bits_total = raw_bits(lay.raw)
    width, height = lay.width, lay.height

    grey = []  # an old-style JPEG's one plane, decoded once
    held = []  # Pillow's strip buffer as the last strip left it
    fax_mode = {}  # libtiff's CCITT codec state (FAXMODE_NOEOL, the run arrays), strip to strip

    def decode(index, seg_w, seg_h, rows, row_bytes, last_strip, what):
        if lay.compression == 6:
            if spp != 1:
                raise ValueError(f"{path}: TIFF: old-style JPEG with {spp} samples and photometric "
                                 f"{_PHOTOMETRIC.get(lay.photometric, lay.photometric)} (libtiff hands Pillow "
                                 "samples its unpacker does not read: Pillow's decoder fails on it)")
            if not grey:
                grey.append(ojpeg_samples(path, data, lay)[0])
            y = index * lay.rows_per_strip
            return np.ascontiguousarray(grey[0][y:y + rows, :seg_w]).reshape(-1)
        chunk, start = chunk_bytes(path, data, lay, index, what)
        if lay.compression == 7:
            return _jpeg_decode(path, data, lay, chunk, seg_w, seg_h, rows, last_strip, plane_spp, what)
        buf = _decompress(path, lay, chunk, start, seg_w, rows, row_bytes * rows, what,
                          previous=held[0] if held and not lay.tiles else None, fax_mode=fax_mode)
        _libtiff_rows(path, lay, buf, rows, row_bytes, plane_spp)
        if not lay.tiles:  # Pillow's strip buffer, which the next strip decodes into
            if not held:
                held.append(np.zeros(row_bytes * min(lay.rows_per_strip, height), np.uint8))
            held[0][:buf.size] = buf
        return buf

    if lay.tiles:
        tw, tl = lay.tiles
        if tw <= 0 or tl <= 0:
            raise ValueError(f"{path}: TIFF: tile of {tw}x{tl}")
        row_bytes = -(-tw * plane_spp * lay.bits[0] // 8)
        across, down = -(-width // tw), -(-height // tl)
        for ty in range(down):
            for plane in range(min(planes, 4)):
                for tx in range(across):
                    index = plane * across * down + ty * across + tx
                    buf = decode(index, tw, tl, tl, row_bytes, False, f"tile {index}")
                    x, y = tx * tw, ty * tl
                    cw, cl = min(tw, width - x), min(tl, height - y)
                    _place(im, buf.reshape(tl, row_bytes)[:cl], x, y, cw, plane, separate, lay)
        _unpremultiply_planes(im, lay, separate)
        return
    rps = lay.rows_per_strip
    if rps <= 0:
        raise ValueError(f"{path}: TIFF: {rps} rows per strip")
    if rps >= 2 ** 32 - 1:
        rps = height
    rps_clamped = min(rps, height)
    row_bytes = -(-width * plane_spp * lay.bits[0] // 8)
    unpacker_row = (width * bits_total // planes + 7) // 8
    if row_bytes * rps_clamped > unpacker_row * rps:
        raise ValueError(f"{path}: TIFF: strips larger than the unpacker's rows")
    per_plane = -(-height // rps_clamped)
    for y in range(0, height, rps):
        for plane in range(planes):
            index = plane * per_plane + y // rps_clamped
            rows = min(rps_clamped, height - y)
            buf = decode(index, width, rows, rows, row_bytes, y + rows == height, f"strip {index}")
            _place(im, buf.reshape(rows, row_bytes), 0, y, width, plane, separate, lay)
    _unpremultiply_planes(im, lay, separate)


def _place(im, rows, x, y, count, plane, separate, lay):
    """Unpack decoded rows into the image: by the raw mode, or for a planar
    file into the plane's byte of the four-byte pixel (8-bit samples, or the
    high byte of 16-bit ones), as Pillow's R, G, B and A unpackers copy
    them whatever the mode; a CIELab file's a and b planes turn unsigned."""
    if not separate:
        im[y:y + len(rows), x:x + count] = unpack(lay.mode, lay.raw, rows, count)
        return
    v = rows[:, :count] if lay.bits[0] == 8 else rows[:, 1:2 * count:2]
    im[y:y + len(rows), x:x + count, plane] = v ^ 128 if lay.mode == "LAB" and plane else v


def _unpremultiply_planes(im, lay, separate):
    """Pillow's libtiff decoder takes the planes of an RGBA file as
    premultiplied when its first extra sample is unspecified or associated
    alpha (libtiff calls a fourth sample with no ExtraSamples unspecified)."""
    if separate and lay.mode == "RGBA" and (not lay.extra or lay.extra[0] in (0, 1)):
        im[:] = _unpremultiply(im)


# Image.Transpose for each EXIF orientation, as numpy on [H,W,C].
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def read_tiff(path: str) -> Tuple[np.ndarray, str]:
    """The first image of a TIFF as Pillow's array of it, [H,W,C], and its
    mode; see the module's docstring."""
    with open(path, "rb") as f:
        data = f.read()
    lay = tiff_layout(path, data)
    if lay.compression == 1:
        im = _pillow_raw_tiles(path, data, lay)
    elif lay.photometric == 6 and not (lay.compression == 7 and lay.planar == 1):
        from mlinerf_tpu_torch.utils import tiff_rgba

        im = _new_image(lay.mode, lay.height, lay.width)
        im[:] = unpack(lay.mode, lay.raw, tiff_rgba.read_rgba(path, data, lay).reshape(lay.height, -1), lay.width)
    else:
        im = _new_image(lay.mode, lay.height, lay.width)
        _libtiff_decode(path, data, lay, im)
    arr = _as_array(lay.mode, im)
    if lay.orientation in _ORIENT:
        arr = np.ascontiguousarray(_ORIENT[lay.orientation](arr))
    return arr, lay.mode
