"""Image input and output on the host: float maps to 8-bit RGB, PNG files
written with the standard library (``zlib`` and ``struct``), PNG, JPEG,
TIFF, BMP, WebP and JPEG 2000 files read to what Pillow's ``Image.open``
gives (PNG with ``zlib`` and a small native library for the row filters,
JPEG with a native decoder, TIFF and BMP in utils/image_containers.py, WebP
in utils/image_webp.py, JPEG 2000 in utils/image_jpeg2000.py),
animated PNGs (APNG) for the relighting videos, collages of labelled tiles
(the labels drawn with a small bitmap font kept here), and a resize to
Pillow's definition of ``Image.resize`` for each of those modes. Nothing
beyond numpy is needed: neither Pillow nor OpenCV."""

from __future__ import annotations

import ctypes
import functools
import os
import re
import struct
import threading
import zlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from mlinerf_tpu_torch.utils import image_containers, image_jpeg2000, image_webp


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


# ---------------------------------------------------------------------------
# PNG writing
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> colour type: grey, RGB, RGBA


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _filter_rows(img: np.ndarray, filters: np.ndarray) -> bytes:
    """The scanlines of ``img`` [H,W,C] uint8, row y filtered by
    ``filters[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), each with its
    filter byte in front."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[:, c:] = up[:, :-c]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])
    pred = preds[np.asarray(filters, np.int64), np.arange(h)]
    out = np.empty((h, w * c + 1), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = (x - pred) & 0xFF
    return out.tobytes()


def _png_image(img: np.ndarray, filters: Optional[Sequence[int]] = None) -> Tuple[bytes, bytes]:
    """(IHDR body, compressed image data) of ``img`` [H,W,C] uint8 (C = 1,
    3 or 4), row y filtered by ``filters[y]`` (default: 0, None)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if img.dtype != np.uint8 or c not in _PNG_COLOUR_TYPE:
        raise ValueError(f"PNG images are uint8 grey, RGB or RGBA; got {img.dtype} with {c} channels")
    filters = np.zeros(h, np.uint8) if filters is None else np.asarray(filters, np.uint8)
    if filters.shape != (h,) or filters.max(initial=0) > 4:
        raise ValueError(f"PNG: one filter type 0-4 per row is needed, got {filters.shape}")
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOUR_TYPE[c], 0, 0, 0)
    return header, zlib.compress(_filter_rows(img, filters), 6)


def save_png(path: str, img: np.ndarray, filters: Optional[Sequence[int]] = None):
    """Write ``img`` [H,W,C] uint8 (C = 1, 3 or 4) as an 8-bit grey, RGB or
    RGBA PNG; row y is filtered by ``filters[y]`` (default: 0, None)."""
    header, data = _png_image(img, filters)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header) + _png_chunk(b"IDAT", data) + _png_chunk(b"IEND", b""))


def write_apng(path: str, frames: Sequence[np.ndarray], fps: int = 30):
    """Write frames [H,W,C] uint8 (all one shape) as an animated PNG that
    plays each frame for 1/fps s and loops forever; the first frame is the
    file's still image. Every row is Up-filtered."""
    frames = list(frames)
    shape = np.asarray(frames[0]).shape
    if any(np.asarray(f).shape != shape for f in frames):
        raise ValueError("write_apng: the frames differ in shape")
    up = np.full(shape[0], 2, np.uint8)
    header = None
    chunks, seq = [], 0
    for i, frame in enumerate(frames):
        header, data = _png_image(frame, up)
        # fcTL: sequence, width, height, x and y offsets, delay fps/1 s, dispose none, blend source.
        chunks.append(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, shape[1], shape[0], 0, 0, 1, fps, 0, 0)))
        seq += 1
        if i == 0:
            chunks.append(_png_chunk(b"IDAT", data))
        else:
            chunks.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    actl = _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header) + actl + b"".join(chunks) + _png_chunk(b"IEND", b""))


def save_image(path: str, image: np.ndarray, from_range: Tuple[float, float] = (0.0, 1.0)):
    """Write ``image`` (see :func:`to_uint8`) as an 8-bit RGB PNG."""
    save_png(path, to_uint8(image, from_range))


# ---------------------------------------------------------------------------
# Reading: PNG and JPEG, as Pillow's Image.open gives them (TIFF and BMP:
# utils/image_containers.py)
# ---------------------------------------------------------------------------

# (bit depth, colour type) -> Pillow's mode (PngImagePlugin._MODES): 16-bit
# samples keep their high byte except in I;16; 16-bit grey+alpha reads as
# RGBA; 2- and 4-bit grey are scaled to 0-255, palette indices are not.
_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB",
              (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA",
              (8, 6): "RGBA", (16, 6): "RGBA"}
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples per pixel of each colour type
# Adam7's passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_JPEG_SIGNATURE = b"\xff\xd8\xff"
_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
# Pillow's ImageFile.MAXBLOCK: it hands libjpeg a JPEG this many bytes at a
# time, and libjpeg's arithmetic decoder cannot wait for the next block, so
# Pillow refuses an arithmetic-coded scan that reads past the blocks read
# before the scan started. The reader refuses it too.
PILLOW_READ_BLOCK = 65536
# Pillow's Image.MAX_IMAGE_PIXELS: twice it is a DecompressionBombError.
_PILLOW_MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)

_UNFILTER = None
_JPEG = None
_LIB_LOCK = threading.Lock()  # datasets decode on several threads


def _unfilter_lib():
    """``build/libpng_unfilter.so`` (csrc/png_unfilter.cpp), built with g++
    at first use; a failed build raises."""
    global _UNFILTER
    with _LIB_LOCK:
        if _UNFILTER is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("png_unfilter")
            lib.png_unfilter.restype = ctypes.c_int64
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p]
            _UNFILTER = lib
        return _UNFILTER


def _jpeg_lib():
    """``build/libjpeg_decode.so`` (csrc/jpeg_decode.cpp), built with g++ at
    first use; a failed build raises."""
    global _JPEG
    with _LIB_LOCK:
        if _JPEG is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("jpeg_decode")
            lib.jpeg_decode.restype = ctypes.c_int64
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.jpeg_tiff_decode.restype = ctypes.c_int64
            lib.jpeg_tiff_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_int64]
            lib.jpeg_raw_decode.restype = ctypes.c_int64
            lib.jpeg_raw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            _JPEG = lib
        return _JPEG


class PngLayout(NamedTuple):
    """An IHDR: height, width, bit depth, colour type, interlace (0 or 1)
    and the Pillow mode the file reads as."""
    h: int
    w: int
    depth: int
    ctype: int
    interlace: int
    mode: str

    @property
    def samples(self) -> int:
        return _PNG_SAMPLES[self.ctype]

    def describe(self) -> str:
        return f"bit depth {self.depth}, colour type {self.ctype}, interlace {self.interlace}"

    def passes(self):
        """(x0, y0, dx, dy, rows, columns) of each non-empty pass: the whole
        image, or Adam7's seven."""
        for x0, y0, dx, dy in (_ADAM7 if self.interlace else ((0, 0, 1, 1),)):
            rows, cols = -(-(self.h - y0) // dy), -(-(self.w - x0) // dx)
            if rows > 0 and cols > 0:
                yield x0, y0, dx, dy, rows, cols

    def row_bytes(self, cols: int) -> int:
        return -(-cols * self.samples * self.depth // 8)


def _png_chunks(path: str):
    """(tag, body) of each chunk of a PNG file, up to IEND."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IEND":
            break


_CHUNK_TYPE = re.compile(rb"\w\w\w\w")  # Pillow's is_cid


def _pillow_png_layout(path: str, header: bytes) -> PngLayout:
    """An IHDR as Pillow's chunk_IHDR reads it: any interlace byte but 0 is
    Adam7, the compression byte is not looked at, a filter method other
    than 0 or a layout with no Pillow mode raises."""
    if len(header) < 13:
        raise ValueError(f"{path}: PNG: truncated IHDR chunk")
    w, h, depth, ctype, _, filter_method, interlace = struct.unpack(">IIBBBBB", header[:13])
    mode = _PNG_MODES.get((depth, ctype))
    if mode is None or filter_method != 0 or w == 0 or h == 0:
        raise ValueError(f"{path}: not a valid PNG layout (bit depth {depth}, colour type {ctype}, "
                         f"filter method {filter_method}, {w}x{h})")
    if w * h > 2 * _PILLOW_MAX_IMAGE_PIXELS:
        raise ValueError(f"{path}: PNG of {w}x{h} pixels (Pillow's decompression bomb limit)")
    return PngLayout(h, w, depth, ctype, int(interlace != 0), mode)


def _png_pieces(path: str, data: bytes):
    """Walks a PNG's chunks as Pillow's PngImagePlugin does and yields the
    pieces of image data it hands its decoder: the layout first, then each
    IDAT chunk's data in reads of at most Pillow's MAXBLOCK bytes. Every
    chunk before the first IDAT must have a chunk type of four word
    characters and its CRC (IHDR's included), as Pillow checks them; the
    IDAT chunks' CRCs are not read. A chunk header that is not one, met
    while the decoder still wants data, raises."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, layout = 8, None
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: PNG: truncated before its image data")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if not _CHUNK_TYPE.match(tag):
            raise ValueError(f"{path}: broken PNG file (chunk {tag!r})")
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IDAT":
            break
        if len(body) < length:
            raise ValueError(f"{path}: PNG: chunk {tag!r} runs past the end of the file")
        if tag == b"IHDR":
            layout = _pillow_png_layout(path, body)
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"{path}: broken PNG file (bad header checksum in {tag!r})")
        pos += 12 + length
    if layout is None:
        raise ValueError(f"{path}: PNG without IHDR")
    yield layout
    view = memoryview(data)  # the pieces are views: the caller joins them once
    while tag == b"IDAT":
        body = view[pos + 8:pos + 8 + length]
        for at in range(0, len(body), PILLOW_READ_BLOCK):
            yield body[at:at + PILLOW_READ_BLOCK]
        pos += 12 + length
        if pos + 8 > len(data):
            return
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if not _CHUNK_TYPE.match(tag):
            raise ValueError(f"{path}: broken PNG file (chunk {tag!r})")


def inflate_png(path: str) -> Tuple[bytes, PngLayout]:
    """The inflated image data of a PNG (each pass's rows, each its filter
    byte then its samples) and its layout, as Pillow's zip decoder inflates
    it from the pieces Pillow reads (``_png_pieces``; see
    :func:`_inflate_rows`)."""
    with open(path, "rb") as f:
        data = f.read()
    pieces = _png_pieces(path, data)
    layout = next(pieces)
    return _inflate_rows(path, layout, pieces), layout


def _inflate_rows(path: str, layout: PngLayout, pieces) -> bytes:
    """The layout's rows inflated from the zlib stream in ``pieces`` (an
    iterable of bytes that may raise ValueError where the file breaks off)
    as Pillow's zip decoder inflates them: a row at a time, done once the
    last row is out. So a damaged stream reads as Pillow reads it: an error
    zlib meets before the last row is out (or while it decodes the code
    after it, the Adler-32 at the stream's end included when Pillow's piece
    holds it) raises, as it does in Pillow; the rest of the stream is not
    read. Data that ends before the last row raises too (Pillow: "image
    file is truncated"). A stream that inflates to every row at once, with
    no error, reads the same row by row and is taken whole."""
    rows = [layout.row_bytes(cols) + 1 for *_, n, cols in layout.passes() for _ in range(n)]
    total, seen, broken = sum(rows), [], None
    try:
        for piece in pieces:
            seen.append(piece)
    except ValueError as e:
        broken = e
    try:
        whole = zlib.decompressobj().decompress(b"".join(seen), total)
        if len(whole) == total:
            return whole
    except zlib.error:
        pass
    inflater, out, row, have = zlib.decompressobj(), [], 0, 0
    try:
        for piece in seen:
            while piece and row < len(rows):
                got = inflater.decompress(piece, rows[row] - have)
                piece = inflater.unconsumed_tail
                out.append(got)
                have += len(got)
                if have == rows[row]:
                    row, have = row + 1, 0
                elif inflater.eof:
                    break
            if row == len(rows):
                return b"".join(out)
    except zlib.error as e:
        raise ValueError(f"{path}: PNG: broken data stream ({e})") from None
    if broken is not None:
        raise broken
    raise ValueError(f"{path}: PNG: image data ends after {row} of {len(rows)} rows ({layout.describe()})")


def _unpack(rows: np.ndarray, cols: int, layout: PngLayout) -> np.ndarray:
    """Unfiltered rows [R, row bytes] -> samples [R, cols, samples] (uint8,
    or uint16 at bit depth 16)."""
    s, depth = layout.samples, layout.depth
    if depth == 8:
        return rows[:, :cols * s].reshape(len(rows), cols, s)
    if depth == 16:
        return rows[:, :cols * s * 2].copy().view(">u2").astype(np.uint16).reshape(len(rows), cols, s)
    bits = np.unpackbits(rows, axis=1).reshape(len(rows), -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :cols, None]


def _to_mode(samples: np.ndarray, layout: PngLayout) -> np.ndarray:
    """Raw samples [H,W,S] -> the array of Pillow's mode for the layout."""
    depth, ctype = layout.depth, layout.ctype
    if layout.mode == "1":
        return samples != 0
    if ctype == 0 and depth in (2, 4):
        return samples * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16 and layout.mode != "I;16":
        high = (samples >> 8).astype(np.uint8)
        return high[..., [0, 0, 0, 1]] if ctype == 4 else high
    return samples


def _decode_png(path: str, raw: bytes, layout: PngLayout) -> np.ndarray:
    """Unfilter each pass on its own (csrc/png_unfilter.cpp), unpack its
    samples, scatter it into the image and give it Pillow's mode."""
    lib = _unfilter_lib()
    bpp = max(1, layout.samples * layout.depth // 8)
    dtype = np.uint16 if layout.depth == 16 else np.uint8
    out = None
    pos = 0
    for index, (x0, y0, dx, dy, rows, cols) in enumerate(layout.passes()):
        stride = layout.row_bytes(cols)
        data = raw[pos:pos + rows * (stride + 1)]
        pos += rows * (stride + 1)
        unfiltered = np.empty((rows, stride), np.uint8)
        bad_row = lib.png_unfilter(data, rows, stride, bpp, unfiltered.ctypes.data)
        if bad_row >= 0:
            where = f"Adam7 pass {index + 1} row {bad_row}" if layout.interlace else f"row {bad_row}"
            raise ValueError(f"{path}: PNG {where} has unknown filter type {data[bad_row * (stride + 1)]}")
        samples = _unpack(unfiltered, cols, layout)
        if not layout.interlace:
            out = samples
            break
        if out is None:
            out = np.empty((layout.h, layout.w, layout.samples), dtype)
        out[y0::dy, x0::dx] = samples
    return _to_mode(out, layout)


def _read_png(path: str) -> Tuple[np.ndarray, str]:
    raw, layout = inflate_png(path)
    return _decode_png(path, raw, layout), layout.mode


def read_png(path: str) -> np.ndarray:
    """A PNG of any bit depth, colour type and interlace as Pillow's array
    of it, [H,W,C] (see :func:`read_image`; 8-bit grey, RGB and RGBA read as
    uint8 with C = 1, 3, 4). tRNS is read past, as Pillow keeps it out of
    the array. Anything else raises ValueError."""
    return _read_png(path)[0]


# What libjpeg warns of as it reads a damaged file and carries on, as
# read_jpeg counts it (csrc/jpeg_decode.cpp).
JPEG_WARNINGS = ("hit_marker", "bad_huffman_code", "restart_resync", "arithmetic_bad_code")


def read_jpeg(path: str, warnings: Optional[dict] = None) -> Tuple[np.ndarray, str]:
    """A JPEG as Pillow's array of it, uint8 [H,W,C], and its mode: "L"
    (one component), "RGB" (three: YCbCr converted, or RGB where an Adobe
    marker says so or, in a lossless file, where no marker says otherwise)
    or "CMYK" (four, inverted as Pillow reads Adobe's CMYK). Decoded by
    csrc/jpeg_decode.cpp to libjpeg-turbo's samples: baseline, extended and
    progressive Huffman-coded DCT (SOF0-2), arithmetic-coded DCT (SOF9 and
    SOF10, with DAC conditioning), lossless Huffman-coded (SOF3: predictors
    1-7, point transforms), restart intervals, and libjpeg's block smoothing
    of a progressive file whose scans leave low AC coefficients incomplete.
    A file Pillow refuses (hierarchical or SOF11 frames, a precision other
    than 8 bits, 2 components, lossless YCbCr, truncated data, an
    arithmetic-coded scan that reads past the PILLOW_READ_BLOCK blocks read
    before it) or that the decoder cannot decode raises ValueError naming
    the reason. Damaged entropy-coded data reads as libjpeg-turbo reads it
    (a segment that meets a marker or ends early decodes as zeros, a bad
    Huffman code as symbol 0, restart markers resynchronised, an
    arithmetic-coded overflow ends the restart interval); ``warnings``, a
    dict, gets the count of each of JPEG_WARNINGS."""
    with open(path, "rb") as f:
        data = f.read()
    lib = _jpeg_lib()
    dims = np.zeros(15, np.int64)  # H, W, C, each component's sampling factors, then the warnings
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), PILLOW_READ_BLOCK, None, 0, dims.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{path}: JPEG: {err.value.decode()}")
    out = np.empty(tuple(int(d) for d in dims[:3]), np.uint8)
    if lib.jpeg_decode(data, len(data), PILLOW_READ_BLOCK, out.ctypes.data, out.size, dims.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{path}: JPEG: {err.value.decode()}")
    if warnings is not None:
        warnings.update(zip(JPEG_WARNINGS, (int(v) for v in dims[11:15])))
    return out, _JPEG_MODES[out.shape[-1]]


def read_image(path: str) -> Tuple[np.ndarray, str]:
    """A PNG, JPEG, TIFF, BMP, WebP or JPEG 2000 file (a JP2 file or a raw
    codestream), told apart by its signature as
    ``Image.open`` does: (``np.asarray(Image.open(path))`` as [H,W,C], its
    Pillow mode). The mode names the array: "1" is bool [H,W,1]; "L" and "P"
    (palette indices, the palette not applied) uint8 [H,W,1]; "LA", "PA",
    "RGB", "RGBA", "CMYK" and "LAB" uint8 with 2, 2, 3, 4, 4, 3 channels;
    "I;16" uint16 and "I;16B" big-endian uint16 [H,W,1]; "I" int32 and "F"
    float32 [H,W,1]. TIFF and BMP are read by utils/image_containers.py,
    WebP ("RGB" or "RGBA", frame 0 of an animation) by utils/image_webp.py,
    JPEG 2000 by utils/image_jpeg2000.py. Any other signature (GIF, AVIF,
    ...) raises ValueError."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:8] == _PNG_SIGNATURE:
        return _read_png(path)
    if head[:3] == _JPEG_SIGNATURE:
        return read_jpeg(path)
    if head[:4] in image_containers.TIFF_SIGNATURES:
        return image_containers.read_tiff(path)
    if head[:2] == image_containers.BMP_SIGNATURE:
        return image_containers.read_bmp(path)
    if image_webp.is_webp(head):
        return image_webp.read_webp(path)
    if image_jpeg2000.is_jpeg2000(head):
        return image_jpeg2000.read_jpeg2000(path)
    raise ValueError(f"{path}: not a PNG, JPEG, TIFF, BMP, WebP or JPEG 2000 file")


def read_apng(path: str) -> Tuple[list, list]:
    """The frames of an animated PNG whose frames each cover the whole
    image (as :func:`write_apng` writes them): ([H,W,C] per frame, each
    frame's delay in seconds). A frame over a region, or blended over the
    previous one, raises ValueError."""
    header, frames, delays, current = None, [], [], None
    for tag, body in _png_chunks(path):
        if tag == b"IHDR":
            header = body
        elif tag == b"fcTL":
            _, fw, fh, x, y, num, den, _dispose, blend = struct.unpack(">IIIIIHHBB", body)
            layout = _pillow_png_layout(path, header or b"")
            if (fw, fh, x, y) != (layout.w, layout.h, 0, 0) or (blend != 0 and frames):
                raise ValueError(f"{path}: APNG frame {len(delays)} covers a region or blends")
            delays.append(num / (den or 100))
            current = []
            frames.append(current)
        elif tag in (b"IDAT", b"fdAT") and current is not None:
            current.append(body if tag == b"IDAT" else body[4:])
    layout = _pillow_png_layout(path, header or b"")
    return [_decode_png(path, _inflate_rows(path, layout, [b"".join(parts)]), layout) for parts in frames], delays


# ---------------------------------------------------------------------------
# Resize, to Pillow's definition
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (Keys, a = -0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=16)
def _resample_weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The taps of one axis as Pillow's ``precompute_coeffs`` computes them:
    support scaled by the downscale factor, weights normalised in double.
    Returns the input index [out, K] and the weight [out, K] of each tap
    (0 past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int() truncates toward zero, as C's cast
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmin, xmin + xmax) - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in w.tolist():  # summed in order, as Pillow sums them
            ww += v
        if ww != 0.0:
            w = w / ww
        index[xx, :xmax] = np.arange(xmin, xmin + xmax)
        weight[xx, :xmax] = w
    return index, weight


@functools.lru_cache(maxsize=16)
def _resample_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The taps in Pillow's 8-bit fixed point (``normalize_coeffs_8bpc``):
    each weight rounded half away from zero to 22 fractional bits."""
    index, weight = _resample_weights(in_size, out_size)
    scaled = weight * (1 << _PRECISION_BITS)
    return index, np.trunc(scaled + np.where(scaled < 0, -0.5, 0.5)).astype(np.int32)


def _resample_axis(img: np.ndarray, in_size: int, out_size: int, axis: int) -> np.ndarray:
    """One pass over ``axis`` (0 rows, 1 columns) of uint8 [H,W,C]: the
    integer sum of each window with its half-unit offset, shifted down and
    clipped to uint8, as Pillow's 8-bit pass."""
    index, coeff = _resample_taps(in_size, out_size)
    # int32 as in Pillow: a window's |coefficients| sum to under 2^23, so
    # 255 times that cannot overflow.
    x = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(index.shape[1]):
        acc += x[index[:, k]] * coeff[:, k].reshape(-1, 1, 1)
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def _resample_axis_16(img: np.ndarray, in_size: int, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 16-bit resample (``ImagingResample*_16bpc``) over
    uint16 [H,W,1]: the window's sum in double, tap by tap, rounded half
    away from zero, then stored as Pillow stores it, the low byte clipped to
    0-255 from the C remainder and the high byte clipped from the shift."""
    index, weight = _resample_weights(in_size, out_size)
    x = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.float64)
    acc = np.zeros((out_size,) + x.shape[1:], np.float64)
    for k in range(index.shape[1]):
        acc += x[index[:, k]] * weight[:, k].reshape(-1, 1, 1)
    v = np.trunc(np.where(acc >= 0.0, acc + 0.5, acc - 0.5)).astype(np.int64)
    low = np.clip(np.fmod(v, 256), 0, 255)
    high = np.clip(v >> 8, 0, 255)
    return np.moveaxis((low + (high << 8)).astype(np.uint16), 0, axis)


@functools.lru_cache(maxsize=16)
def _resample_counts(in_size: int, out_size: int) -> np.ndarray:
    """How many of each output's taps lie in the image (``precompute_coeffs``'
    xmax): the 32-bit passes add exactly these."""
    scale = in_size / out_size
    support = 2.0 * max(scale, 1.0)
    centers = (np.arange(out_size) + 0.5) * scale
    lo = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    return np.minimum((centers + support + 0.5).astype(np.int64), in_size) - lo


def _resample_axis_32(img: np.ndarray, in_size: int, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 32-bit resample (``ImagingResample*_32bpc``)
    over int32 "I" or float32 "F" [H,W,1]: each window's taps summed in
    double, in order; "I" rounds half away from zero to int32 (a sum past
    its range stores C's out-of-range conversion, INT32_MIN), "F" stores
    the sum as float32."""
    index, weight = _resample_weights(in_size, out_size)
    count = _resample_counts(in_size, out_size)
    x = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    acc = np.zeros((out_size,) + x.shape[1:], np.float64)
    for k in range(index.shape[1]):
        live = count > k
        acc[live] += x[index[live, k]].astype(np.float64) * weight[live, k].reshape(-1, 1, 1)
    if img.dtype == np.float32:
        with np.errstate(over="ignore"):  # past float32's range: inf, as C's conversion gives
            return np.moveaxis(acc.astype(np.float32), 0, axis)
    v = np.trunc(np.where(acc >= 0.0, acc + 0.5, acc - 0.5))
    v = np.where((v >= -2.0 ** 31) & (v < 2.0 ** 31), v, -2.0 ** 31)
    return np.moveaxis(v.astype(np.int32), 0, axis)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output pixel of Pillow's nearest resize
    (``ImagingScaleAffine``): a position stepped by repeated addition of
    in/out from half a step, truncated; -1 where it falls outside."""
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    idx = pos.astype(np.int64)
    return np.where(idx < in_size, idx, -1)


def _resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    out_w, out_h = size
    xi, yi = _nearest_index(img.shape[1], out_w), _nearest_index(img.shape[0], out_h)
    out = img[np.maximum(yi, 0)][:, np.maximum(xi, 0)]
    out[yi < 0] = 0
    out[:, xi < 0] = 0
    return out


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> premultiplied RGBa (or LA -> La), as Pillow converts:
    (c*a + 128) / 255 by its shift form."""
    rgb, a = img[..., :-1].astype(np.uint32), img[..., -1:].astype(np.uint32)
    t = rgb * a + 128
    return np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8), img[..., -1:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Premultiplied RGBa -> RGBA (or La -> LA), as Pillow converts back:
    255*c / a, truncated and clipped; alpha 0 and 255 keep their colour."""
    rgb, a = img[..., :-1].astype(np.uint32), img[..., -1:].astype(np.uint32)
    div = np.minimum(255 * rgb // np.maximum(a, 1), 255)
    keep = (a == 0) | (a == 255)
    return np.concatenate([np.where(keep, rgb, div).astype(np.uint8), img[..., -1:]], axis=-1)


def _default_mode(img: np.ndarray) -> str:
    if img.dtype == bool:
        return "1"
    if img.dtype == np.uint16:
        return "I;16B" if img.dtype.byteorder == ">" else "I;16"
    if img.dtype == np.int32:
        return "I"
    if img.dtype == np.float32:
        return "F"
    return {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[img.shape[-1]]


def resize(img: np.ndarray, size: Tuple[int, int], mode: Optional[str] = None) -> np.ndarray:
    """Resize [H,W,C] to ``size`` = (W, H) as Pillow's ``Image.resize(size)``
    does for an image of ``mode`` (default: bool "1", uint16 "I;16" (or
    big-endian "I;16B"), int32 "I", float32 "F", else by channels "L",
    "LA", "RGB", "RGBA"). "1" and "P" take the nearest pixel. The others
    are separable antialiased bicubic, the horizontal pass first and stored
    before the vertical one: 8-bit in Pillow's fixed point ("LA" and "RGBA"
    premultiplied by alpha around it, "PA" and "CMYK" as plain channels,
    "LAB"'s a and b as signed), "I;16" in its 16-bit path ("I;16B" too,
    which that path reads and writes as little-endian bytes), "I" and "F"
    in its 32-bit path."""
    mode = mode or _default_mode(img)
    out_w, out_h = int(size[0]), int(size[1])
    h, w, _ = img.shape
    if (out_w, out_h) == (w, h):
        return img.copy()
    if mode in ("1", "P"):
        return _resize_nearest(img, (out_w, out_h))
    if mode == "I;16B":  # Pillow's 16-bit pass takes the bytes as little-endian
        return np.ascontiguousarray(resize(img.astype(">u2").view("<u2"), size, "I;16")).view(">u2")
    if mode == "LAB":
        signed = img ^ np.array([0, 128, 128], np.uint8)
        return resize(signed, size, "RGB") ^ np.array([0, 128, 128], np.uint8)
    axis_pass = {"I;16": _resample_axis_16, "I": _resample_axis_32, "F": _resample_axis_32}.get(mode, _resample_axis)
    out = _premultiply(img) if mode in ("LA", "RGBA") else img
    if out_w != w:
        out = axis_pass(out, w, out_w, axis=1)
    if out_h != h:
        out = axis_pass(out, h, out_h, axis=0)
    return _unpremultiply(out) if mode in ("LA", "RGBA") else out


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Read a PNG, JPEG, TIFF, BMP, WebP or JPEG 2000 file (see :func:`read_image`) as
    float32 [H,W,C], Pillow's array divided by 255 whatever its mode, as the
    JAX package's ``load_image`` divides it (so palette indices stay
    indices, 16-bit grey reaches 257 and an "I" or "F" frame is its values
    over 255); ``size`` = (W, H) resizes it first (see :func:`resize`)."""
    img, mode = read_image(path)
    if size is not None:
        img = resize(img, size, mode)
    return img.astype(np.float32) / np.float32(255.0)


# ---------------------------------------------------------------------------
# Collages of labelled tiles (the relighting videos' frames)
# ---------------------------------------------------------------------------


def create_collage(frame_imgs, padding: int = 5) -> np.ndarray:
    """Tile images (all one size, [H,W,3] uint8) row by row into a
    near-square collage on white, ``padding`` white columns between tiles."""
    img_height, img_width, _ = frame_imgs[0].shape
    rows = int(np.sqrt(len(frame_imgs)))
    cols = int(np.ceil(len(frame_imgs) / rows))
    collage = np.full((img_height * rows, img_width * cols + padding * (cols - 1), 3), 255, np.uint8)
    for idx, img in enumerate(frame_imgs):
        r, c = idx // cols, idx % cols
        y0, x0 = r * img_height, c * (img_width + padding)
        collage[y0:y0 + img_height, x0:x0 + img_width] = img
    return collage


# A 5x9 bitmap font: seven rows down to the baseline and two of descender,
# one string of 5 cells per row ("#" inked). Capitals are drawn as small
# letters; any other missing character as "?".
_GLYPHS = {
    "a": ".....|.....|.###.|....#|.####|#...#|.####", "b": "#....|#....|#.##.|##..#|#...#|#...#|####.",
    "c": ".....|.....|.###.|#....|#....|#...#|.###.", "d": "....#|....#|.##.#|#..##|#...#|#...#|.####",
    "e": ".....|.....|.###.|#...#|#####|#....|.###.", "f": "..##.|.#..#|.#...|###..|.#...|.#...|.#...",
    "g": ".....|.....|.####|#...#|#...#|#...#|.####|....#|.###.",
    "h": "#....|#....|#.##.|##..#|#...#|#...#|#...#", "i": "..#..|.....|.##..|..#..|..#..|..#..|.###.",
    "j": "...#.|.....|..##.|...#.|...#.|...#.|...#.|#..#.|.##..",
    "k": "#....|#....|#..#.|#.#..|##...|#.#..|#..#.", "l": ".##..|..#..|..#..|..#..|..#..|..#..|.###.",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#...#|#...#", "n": ".....|.....|#.##.|##..#|#...#|#...#|#...#",
    "o": ".....|.....|.###.|#...#|#...#|#...#|.###.",
    "p": ".....|.....|####.|#...#|#...#|#...#|####.|#....|#....",
    "q": ".....|.....|.####|#...#|#...#|#...#|.####|....#|....#",
    "r": ".....|.....|#.##.|##..#|#....|#....|#....", "s": ".....|.....|.####|#....|.###.|....#|####.",
    "t": ".#...|.#...|###..|.#...|.#...|.#..#|..##.", "u": ".....|.....|#...#|#...#|#...#|#..##|.##.#",
    "v": ".....|.....|#...#|#...#|#...#|.#.#.|..#..", "w": ".....|.....|#...#|#...#|#.#.#|#.#.#|.#.#.",
    "x": ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#",
    "y": ".....|.....|#...#|#...#|#...#|#...#|.####|....#|.###.",
    "z": ".....|.....|#####|...#.|..#..|.#...|#####",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.", "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####", "3": "####.|....#|....#|.###.|....#|....#|####.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.", "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": "..##.|.#...|#....|####.|#...#|#...#|.###.", "7": "#####|....#|...#.|..#..|.#...|.#...|.#...",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.", "9": ".###.|#...#|#...#|.####|....#|...#.|.##..",
    " ": ".....", "_": ".....|.....|.....|.....|.....|.....|.....|#####", "-": ".....|.....|.....|.###.",
    ".": ".....|.....|.....|.....|.....|.....|..#..", ":": ".....|.....|..#..|.....|.....|.....|..#..",
    "(": "...#.|..#..|.#...|.#...|.#...|..#..|...#.", ")": ".#...|..#..|...#.|...#.|...#.|..#..|.#...",
    "/": "....#|...#.|...#.|..#..|.#...|.#...|#....", "?": ".###.|#...#|....#|...#.|..#..|.....|..#..",
}
_GLYPH_ROWS, _GLYPH_ABOVE, _GLYPH_ADVANCE = 9, 7, 6


@functools.lru_cache(maxsize=None)
def _glyph(char: str) -> np.ndarray:
    """[9, 5] bool cells of a character."""
    rows = _GLYPHS.get(char.lower(), _GLYPHS["?"]).split("|")
    cells = np.zeros((_GLYPH_ROWS, 5), bool)
    for r, row in enumerate(rows):
        cells[r] = [ch == "#" for ch in row]
    return cells


def draw_text(img: np.ndarray, text: str, origin: Tuple[int, int]):
    """Ink ``text`` in black into ``img`` [H,W,3] uint8 in place, left end
    of its baseline at ``origin`` (x, y): 6 pixels a character, 7 rows up
    to and including the baseline's row above it and 2 of descender;
    clipped to the image."""
    x0, base = origin
    top = base - _GLYPH_ABOVE
    for i, char in enumerate(text):
        cells = _glyph(char)
        ys, xs = np.nonzero(cells)
        ys, xs = ys + top, xs + x0 + i * _GLYPH_ADVANCE
        keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
        img[ys[keep], xs[keep]] = 0


def annotate(img: np.ndarray, text: str) -> np.ndarray:
    """``img`` [H,W,3] uint8 with a white strip of max(H // 10, 16) rows
    appended below it, labelled ``text`` from x = 10 on the baseline 6
    rows above the bottom (the JAX package's layout; its glyphs are
    OpenCV's Hershey font, these the bitmap font above)."""
    strip = np.full((max(img.shape[0] // 10, 16), img.shape[1], 3), 255, np.uint8)
    out = np.vstack([img, strip])
    draw_text(out, text, (10, out.shape[0] - 6))
    return out
