"""Image input and output on the host: float maps to 8-bit RGB, PNG files
written with the standard library (``zlib`` and ``struct``) and read with
it and a small native library for the row filters, animated PNGs (APNG)
for the relighting videos, collages of labelled tiles (the labels drawn
with a small bitmap font kept here), and a resize to Pillow's definition of
``Image.resize`` (bicubic, antialiased). Nothing beyond numpy is needed:
neither Pillow nor OpenCV."""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import threading
import zlib
from typing import Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# PNG writing
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type: grey, RGB, RGBA
_PNG_COLOUR_TYPE = {c: t for t, c in _PNG_CHANNELS.items()}


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
# PNG reading
# ---------------------------------------------------------------------------

_UNFILTER = None
_UNFILTER_LOCK = threading.Lock()  # datasets decode on several threads


def _unfilter_lib():
    """``build/libpng_unfilter.so`` (csrc/png_unfilter.cpp), built with g++
    at first use; a failed build raises."""
    global _UNFILTER
    with _UNFILTER_LOCK:
        if _UNFILTER is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("png_unfilter")
            lib.png_unfilter.restype = ctypes.c_int64
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p]
            _UNFILTER = lib
        return _UNFILTER


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


def _image_layout(path: str, header) -> Tuple[int, int, int]:
    """(H, W, C) of an IHDR body; anything but 8-bit non-interlaced grey,
    RGB or RGBA raises ValueError."""
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _compression, _filter, interlace = struct.unpack(">IIBBBBB", header)
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, RGB and RGBA PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    return h, w, _PNG_CHANNELS[ctype]


def _inflate(path: str, compressed: bytes, h: int, w: int, c: int) -> bytes:
    raw = zlib.decompress(compressed)
    if len(raw) != h * (w * c + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of PNG image data, expected {h * (w * c + 1)}")
    return raw


def inflate_png(path: str) -> Tuple[bytes, int, int, int]:
    """The inflated image data of an 8-bit, non-interlaced grey, RGB or RGBA
    PNG: (rows, each its filter byte and W*C samples; H; W; C). Every
    other file raises ValueError."""
    header, idat = None, []
    for tag, body in _png_chunks(path):
        if tag == b"IHDR":
            header = body
        elif tag == b"IDAT":
            idat.append(body)
    h, w, c = _image_layout(path, header)
    if not idat:
        raise ValueError(f"{path}: PNG without IDAT")
    return _inflate(path, b"".join(idat), h, w, c), h, w, c


def _unfilter(path: str, raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    out = np.empty((h, w, c), np.uint8)
    bad_row = _unfilter_lib().png_unfilter(raw, h, w * c, c, out.ctypes.data)
    if bad_row >= 0:
        raise ValueError(f"{path}: PNG row {bad_row} has unknown filter type {raw[bad_row * (w * c + 1)]}")
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey, RGB or RGBA PNG as uint8
    [H,W,C] (C = 1, 3 or 4). Every other file raises ValueError."""
    raw, h, w, c = inflate_png(path)
    return _unfilter(path, raw, h, w, c)


def read_apng(path: str) -> Tuple[list, list]:
    """The frames of an animated PNG whose frames each cover the whole
    image (as :func:`write_apng` writes them): ([H,W,C] uint8 per frame,
    each frame's delay in seconds). A frame over a region, or blended over
    the previous one, raises ValueError."""
    header, frames, delays, current = None, [], [], None
    for tag, body in _png_chunks(path):
        if tag == b"IHDR":
            header = body
        elif tag == b"fcTL":
            _, fw, fh, x, y, num, den, _dispose, blend = struct.unpack(">IIIIIHHBB", body)
            h, w, _ = _image_layout(path, header)
            if (fw, fh, x, y) != (w, h, 0, 0) or (blend != 0 and frames):
                raise ValueError(f"{path}: APNG frame {len(delays)} covers a region or blends")
            delays.append(num / (den or 100))
            current = []
            frames.append(current)
        elif tag in (b"IDAT", b"fdAT") and current is not None:
            current.append(body if tag == b"IDAT" else body[4:])
    h, w, c = _image_layout(path, header)
    return [_unfilter(path, _inflate(path, b"".join(parts), h, w, c), h, w, c) for parts in frames], delays


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
def _resample_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-point taps of one axis, as Pillow computes them
    (``precompute_coeffs`` and ``normalize_coeffs_8bpc``): support scaled by
    the downscale factor, weights normalised in double, then rounded half
    away from zero to 22 fractional bits. Returns the input index [out, K]
    and the integer coefficient [out, K] of each tap (0 past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    coeff = np.zeros((out_size, ksize), np.int32)
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
        scaled = w * (1 << _PRECISION_BITS)
        index[xx, :xmax] = np.arange(xmin, xmin + xmax)
        coeff[xx, :xmax] = np.trunc(scaled + np.where(scaled < 0, -0.5, 0.5))
    return index, coeff


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


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> premultiplied RGBa, as Pillow converts: (c*a + 128) / 255 by
    its shift form."""
    rgb, a = img[..., :3].astype(np.uint32), img[..., 3:].astype(np.uint32)
    t = rgb * a + 128
    return np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8), img[..., 3:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Premultiplied RGBa -> RGBA, as Pillow converts back: 255*c / a,
    truncated and clipped; alpha 0 and 255 keep their colour."""
    rgb, a = img[..., :3].astype(np.uint32), img[..., 3:].astype(np.uint32)
    div = np.minimum(255 * rgb // np.maximum(a, 1), 255)
    keep = (a == 0) | (a == 255)
    return np.concatenate([np.where(keep, rgb, div).astype(np.uint8), img[..., 3:]], axis=-1)


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize uint8 [H,W,C] to ``size`` = (W, H) as Pillow's
    ``Image.resize(size)`` does for 8-bit grey, RGB and RGBA: separable
    antialiased bicubic, the horizontal pass first and rounded to uint8,
    then the vertical pass; RGBA premultiplied by alpha around it."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w, c = img.shape
    if (out_w, out_h) == (w, h):
        return img.copy()
    rgba = c == 4
    out = _premultiply(img) if rgba else img
    if out_w != w:
        out = _resample_axis(out, w, out_w, axis=1)
    if out_h != h:
        out = _resample_axis(out, h, out_h, axis=0)
    return _unpremultiply(out) if rgba else out


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Read a PNG (see :func:`read_png`) as float32 [H,W,C] in [0,1];
    ``size`` = (W, H) resizes it first (see :func:`resize`)."""
    img = read_png(path)
    if size is not None:
        img = resize(img, size)
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
