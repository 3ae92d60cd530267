"""Datasets in the paper's and the NeRF family's file layouts, made without
their images.

The ReNe, MLI-synthetic, NRHints, NeRF-synthetic and LLFF images cannot be
shipped, so the tests and the GPU smoke write stand-ins in the same layouts:
the ReNe layout takes its cameras, lights and intrinsics from an annotation
directory such as ``dataset_rene/savannah``; the MLI-synthetic and NRHints
layouts put cameras on a ring around the origin with a point light per
frame; the NeRF-synthetic layout (lego's) puts them on a sphere of radius 4
with RGBA frames; the LLFF layout (fern's) faces forward, with
``poses_bounds.npy``. Every image is a render of the procedural
``cluttered`` scene (``data/synthetic.py``), with sensor noise drawn from
``seed``, written by ``save(path, uint8 [H,W,C])``: PNG by default, or with
``image_format="jpeg"`` (fern's and NRHints' captures are JPEG) through the
baseline encoder below, or for NRHints' layout in one of the TIFF, BMP,
WebP and JPEG 2000 codings of ``FRAME_FORMATS`` (``encode_tiff``, with the
codings of libtiff's other codecs and old-style JPEG in
``data/tiff_encode.py``; ``encode_bmp``; ``encode_webp``;
``encode_jpeg2000``), frame by frame; the encoders exist for these
stand-ins and the tests only.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mlinerf_tpu_torch.data import jpeg2000_encode, tiff_encode, webp_encode
from mlinerf_tpu_torch.data.blender import gl_to_cv, invert_pose
from mlinerf_tpu_torch.data.synthetic import look_at_pose, render_cluttered_image
from mlinerf_tpu_torch.utils.image_io import save_png

Saver = Callable[[str, np.ndarray], None]
# The cluttered scene fills the unit sphere; a ReNe scene fits a box of
# about 1.3 x 0.9 x 0.5 around the origin.
RENE_SCENE_SCALE = 0.4
# ReNe frames render at a quarter of the raw size and are repeated up to
# it (a 1440x1080 render takes seconds on a host core).
RENE_RENDER_DIV = 4


def camera_filters(h: int, rng: np.random.Generator) -> np.ndarray:
    """Per-row PNG filter types as an encoder with adaptive filtering
    leaves them on camera frames: mostly Paeth, every type present."""
    filters = rng.choice(5, size=h, p=[0.05, 0.1, 0.15, 0.1, 0.6]).astype(np.uint8)
    filters[:5] = np.arange(5)
    return filters


def filtered_saver(seed: int = 0) -> Saver:
    """``save`` that writes with :func:`camera_filters`, all five types."""
    rng = np.random.default_rng(seed)

    def save(path, img):
        save_png(path, img, filters=camera_filters(img.shape[0], rng))

    return save


def camera_frame(seed: int, size: Tuple[int, int]) -> np.ndarray:
    """A camera-like RGB frame, uint8 [H,W,3] of ``size`` (W, H): shading,
    edges and sensor noise, made from ``seed``."""
    w, h = size
    rng = np.random.default_rng(seed)
    x, y = np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)[:, None]
    edges = 30 * (((np.arange(w) // 211)[None, :] + (np.arange(h) // 173)[:, None]) % 2).astype(np.float32)
    noise = rng.standard_normal((h, w), dtype=np.float32) * 4
    # sin(a + b) from its separable parts: 127 + 90 sin(x/p + y/q + seed).
    channels = [127 + 90 * (np.sin(x / (97 + 31 * k)) * np.cos(y / (61 + 17 * k) + seed)
                            + np.cos(x / (97 + 31 * k)) * np.sin(y / (61 + 17 * k) + seed)) + edges + noise
                for k in range(3)]
    return np.clip(np.stack(channels, -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# A baseline JPEG encoder for the stand-ins (the captures' own format)
# ---------------------------------------------------------------------------

# T.81 Annex K.1's quantisation tables (natural order), and each zigzag
# position's natural position.
_K1_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                     14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
                     92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_K1_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
                      + [47, 66] + [99] * 38)
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                    13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
                    45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3's Huffman tables: code counts per length 1-16, then the symbols.
_AC_LUMA_SYMBOLS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_SYMBOLS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a353637"
    "38393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3"
    "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_HUFFMAN_TABLES = {  # (class, id): (counts, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _AC_LUMA_SYMBOLS),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _AC_CHROMA_SYMBOLS),
}
# Luma's (h, v) sampling factors per chroma subsampling; chroma's are (1, 1).
JPEG_SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2), "4:1:1": (4, 1)}


@functools.lru_cache(maxsize=None)
def _huffman_codes(table: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol of an Annex K table."""
    return _canonical(*_HUFFMAN_TABLES[table])


def _dct_matrix() -> np.ndarray:
    """[64, 64]: the orthonormal 8x8 2-D DCT-II of a row-major block."""
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    c = np.sqrt(2.0 / 8.0) * np.cos((2 * x + 1) * u * np.pi / 16)
    c[0] /= np.sqrt(2.0)
    return np.kron(c, c).astype(np.float32)


def _magnitude_bits(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, appended bits) of each coefficient (T.81 F.1.2)."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)  # the bit length of |v|
    return size, np.where(v < 0, v + (1 << size) - 1, v).astype(np.int64)


def _pack_bits(value: np.ndarray, length: np.ndarray) -> bytes:
    """The codes (``length`` bits of each ``value``, each at most 32),
    back to back, padded with 1 bits to a byte, each 0xFF byte followed by a
    stuffed 0x00."""
    pad = -int(length.sum()) % 8
    value = np.append(value, (1 << pad) - 1).astype(np.uint64)
    length = np.append(length, pad).astype(np.int64)
    start = np.cumsum(length) - length
    word, offset = start >> 5, start & 31
    # Each code, placed in the 64 bits from its first 32-bit word on; the
    # codes' bits never overlap, so a sum per word is their OR (and exact in
    # float64: each sum is below 2^32).
    placed = value << (64 - length - offset).astype(np.uint64)
    words = np.zeros(int(word[-1]) + 2)
    words += np.bincount(word, weights=(placed >> np.uint64(32)).astype(np.float64), minlength=len(words))
    words[1:] += np.bincount(word, weights=(placed & np.uint64(0xFFFFFFFF)).astype(np.float64),
                             minlength=len(words) - 1)
    data = np.frombuffer(words.astype(">u4").tobytes(), np.uint8)[:int(start[-1] + length[-1]) // 8]
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _quantised(img: np.ndarray, quality: int, subsampling: str, ycck: bool, name: str, convert: bool = True):
    """(height, width, sampling factors, table per component, quantisation
    tables, coefficients) of ``img`` as the DCT encoders below code it:
    ``coefficients[ci]`` holds component ci's quantised blocks, int32
    [blocks down, blocks across, 64] in zigzag order over whole MCUs. The
    Annex K tables scaled to ``quality`` (1-100) as the IJG encoder scales
    them, a float DCT, edges replicated to whole MCUs; ``convert`` False
    codes three or four channels as they are (a TIFF's RGB or RGBA)."""
    img = np.asarray(img, np.uint8)
    img = img[..., None] if img.ndim == 2 else img
    h, w, c = img.shape
    if c not in (1, 3) and not (c == 4 and (ycck or not convert)):
        raise ValueError(f"{name}: {c} channels (1, 3, or 4 with ycck)")
    planes = [img[..., i].astype(np.float32) for i in range(c)]
    if c >= 3 and convert:  # RGB -> YCbCr (T.871); a fourth channel passes
        r, g, b = planes[:3]
        planes[:3] = [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                      128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
    luma = JPEG_SUBSAMPLING[subsampling] if c >= 3 else (1, 1)
    factors = [luma] + [(1, 1)] * (c - 1)
    tables = [0] + [1] * (c - 1)
    mh, mv = luma
    mcux, mcuy = -(-w // (8 * mh)), -(-h // (8 * mv))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qtables = [np.clip((base * scale + 50) // 100, 1, 255) for base in (_K1_LUMA, _K1_CHROMA)]
    dct = _dct_matrix()[_ZIGZAG]  # its rows in zigzag order: the product comes out zigzagged
    coefs = []
    for ci, (fh, fv) in enumerate(factors):
        plane = np.pad(planes[ci], ((0, mcuy * 8 * mv - h), (0, mcux * 8 * mh - w)), mode="edge")
        if (fh, fv) != (mh, mv):
            plane = plane.reshape(mcuy * 8 * fv, mv // fv, mcux * 8 * fh, mh // fh).mean((1, 3))
        bh, bw = mcuy * fv, mcux * fh
        freq = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh * bw, 64) @ dct.T
        freq[:, 0] -= 8 * 128.0  # the level shift, which moves only the DC term
        freq *= (1.0 / qtables[tables[ci]][_ZIGZAG]).astype(np.float32)
        # Rounded, the AC terms kept within the tables' 10-bit categories.
        q = np.rint(freq, out=freq).astype(np.int32)
        np.clip(q[:, 1:], -1023, 1023, out=q[:, 1:])
        coefs.append(q.reshape(bh, bw, 64))
    return h, w, factors, tables, qtables, coefs


_JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _adobe(transform: int) -> bytes:
    """Adobe's APP14: transform 0 (RGB or CMYK as stored), 1 (YCbCr) or 2 (YCCK)."""
    return _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform]))


def _jpeg_head(sof: int, h: int, w: int, factors, tables, qtables, app: bytes, ids=None) -> bytes:
    """SOI, ``app``, the DQT segments of ``qtables`` (none for a lossless
    frame: pass None) and the frame header (8-bit samples)."""
    out = [b"\xff\xd8", app]
    if qtables is not None:
        for t in sorted(set(tables)):
            out.append(_segment(0xDB, bytes([t]) + bytes(qtables[t].astype(np.uint8)[_ZIGZAG].tolist())))
    ids = ids or list(range(1, len(factors) + 1))
    frame = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(factors)])
    frame += b"".join(bytes([ids[ci], (fh << 4) | fv, tables[ci] if qtables is not None else 0])
                      for ci, (fh, fv) in enumerate(factors))
    out.append(_segment(sof, frame))
    return b"".join(out)


def encode_jpeg(img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0", ycck: bool = False) -> bytes:
    """A baseline JPEG of ``img`` uint8 [H,W] or [H,W,C]: C = 1 (grey), 3
    (RGB, stored as JFIF YCbCr with chroma subsampled as ``subsampling``,
    see JPEG_SUBSAMPLING) or 4 with ``ycck`` (Adobe YCCK: the first three
    channels as RGB, the fourth stored as is). The Annex K Huffman tables,
    the coefficients of :func:`_quantised`. For stand-ins only: no loader
    reads through it."""
    h, w, factors, tables, qtables, coefs = _quantised(img, quality, subsampling, ycck, "encode_jpeg")
    c = len(factors)
    out = [_jpeg_head(0xC0, h, w, factors, tables, qtables, _adobe(2) if ycck else _JFIF)]
    for (cls, ident), (counts, symbols) in _HUFFMAN_TABLES.items():
        if ident in tables:
            out.append(_segment(0xC4, bytes([(cls << 4) | ident] + counts) + symbols))
    scan = bytes([c]) + b"".join(bytes([ci + 1, (t << 4) | t]) for ci, t in enumerate(tables)) + bytes([0, 63, 0])
    out += [_segment(0xDA, scan), _baseline_entropy(factors, tables, coefs), b"\xff\xd9"]
    return b"".join(out)


def _baseline_entropy(factors, tables, coefs) -> bytes:
    """The entropy-coded segment of one interleaved baseline scan of every
    component's quantised blocks (:func:`_quantised`) with the Annex K
    Huffman tables."""
    c = len(factors)
    mcuy, mcux = coefs[0].shape[0] // factors[0][1], coefs[0].shape[1] // factors[0][0]
    order, comp_of = [], []
    offset = 0
    for ci, (fh, fv) in enumerate(factors):
        bh, bw = coefs[ci].shape[:2]
        # Block ids in MCU order: each MCU holds this component's fv x fh blocks.
        ids = offset + np.arange(bh * bw).reshape(mcuy, fv, mcux, fh).transpose(0, 2, 1, 3).reshape(mcuy * mcux, -1)
        order.append(ids)
        comp_of.append(np.full(bh * bw, ci))
        offset += bh * bw
    order = np.concatenate(order, axis=1).reshape(-1)
    z = np.concatenate([q.reshape(-1, 64) for q in coefs])[order]
    comp = np.concatenate(comp_of)[order]
    table = np.asarray(tables)[comp]
    for ci in range(c):  # DC as differences along each component's own sequence
        sel = comp == ci
        z[sel, 0] = np.diff(z[sel, 0], prepend=0)
    # Tokens: (block, slot within the block, Huffman table 0-3, symbol,
    # size, appended bits), sorted into the stream by block and slot.
    tokens = []

    def add(blk, slot, tbl, sym, size=None, bits=None):
        zero = np.zeros(len(blk), np.int64)
        tokens.append((blk, slot, tbl, sym, zero if size is None else size, zero if bits is None else bits))

    n = len(z)
    dc_size, dc_bits = _magnitude_bits(z[:, 0])
    add(np.arange(n), np.zeros(n, np.int64), table, dc_size, dc_size, dc_bits)
    nb, nk = np.nonzero(z[:, 1:])  # each block's nonzero AC positions, in order
    nk = nk + 1
    first = np.concatenate([[True], nb[1:] != nb[:-1]]) if len(nb) else np.zeros(0, bool)
    run = nk - np.where(first, 0, np.concatenate([[0], nk[:-1]])) - 1
    zrl = np.repeat(np.arange(len(nb)), run // 16)  # a ZRL symbol per 16 zeros of a run
    add(nb[zrl], 2 * nk[zrl] - 1, 2 + table[nb[zrl]], np.full(len(zrl), 0xF0))
    ac_size, ac_bits = _magnitude_bits(z[nb, nk])
    add(nb, 2 * nk, 2 + table[nb], (run % 16) * 16 + ac_size, ac_size, ac_bits)
    last = np.zeros(n, np.int64)
    last[nb] = nk  # the last write per block is its last nonzero position
    eob = np.flatnonzero(last < 63)
    add(eob, np.full(len(eob), 200), 2 + table[eob], np.zeros(len(eob), np.int64))
    blk, slot, tbl, sym, size, bits = (np.concatenate(a) for a in zip(*tokens))
    sort = np.argsort(blk * 256 + slot, kind="stable")
    tbl, sym, size, bits = tbl[sort], sym[sort], size[sort], bits[sort]
    code, length = np.zeros(len(sym), np.int64), np.zeros(len(sym), np.int64)
    for t in range(4):
        sel = tbl == t
        codes, lengths = _huffman_codes((t // 2, t % 2))
        code[sel], length[sel] = codes[sym[sel]], lengths[sym[sel]]
    return _pack_bits((code << size) | bits, length + size)


# ---------------------------------------------------------------------------
# The other codings Pillow reads (libjpeg-turbo 3.x decodes them): lossless
# (SOF3), progressive with any scan script (SOF2), arithmetic-coded
# sequential and progressive (SOF9, SOF10). They write the test files of
# the port's JPEG reader; the truth is Pillow's reading of each file.
# ---------------------------------------------------------------------------


def _canonical(counts: Sequence[int], symbols: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol of a table, canonical as T.81 C.2."""
    code_of, length_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            code_of[symbols[k]], length_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, length_of


def _optimal_table(counts: np.ndarray) -> Tuple[List[int], bytes]:
    """(code counts per length 1-16, symbols) of a Huffman table for the
    symbol counts ``counts`` [256], built as T.81 K.2 builds one: no code
    longer than 16 bits, the all-ones code left free."""
    freq = [int(v) for v in counts] + [1]  # the reserved symbol 256 keeps the all-ones code free
    size, others = [0] * 257, [-1] * 257
    while True:
        live = sorted((f, -i) for i, f in enumerate(freq) if f)
        if len(live) < 2:
            break
        c1, c2 = -live[0][1], -live[1][1]  # the two least frequent; of equals, the highest symbol first
        freq[c1] += freq[c2]
        freq[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        while others[c1] >= 0:
            c1 = others[c1]
        others[c1] = c2
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):  # K.3's adjustment to 16 bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    symbols = bytes(j for s in range(1, 33) for j in range(256) if size[j] == s)
    return bits[1:17], symbols


class _HuffmanScan:
    """A scan's Huffman-coded data: symbols of the tables keyed (class,
    id) and raw bits, per restart interval, coded with tables made from the
    scan's own counts."""

    def __init__(self):
        self.intervals = [[]]  # (table key or None, symbol or bits, bit count)

    def symbol(self, key, sym):
        self.intervals[-1].append((key, sym, 0))

    def bits(self, value, n):
        if n:
            self.intervals[-1].append((None, value & ((1 << n) - 1), n))

    def restart(self):
        self.intervals.append([])

    def finish(self) -> Tuple[bytes, bytes]:
        """(the DHT segments, the entropy-coded data with its RST markers)."""
        counts = {}
        for interval in self.intervals:
            for key, sym, _ in interval:
                if key is not None:
                    counts.setdefault(key, np.zeros(256, np.int64))[sym] += 1
        tables = {key: _optimal_table(c) for key, c in counts.items()}
        codes = {key: _canonical(*t) for key, t in tables.items()}
        dht = b"".join(_segment(0xC4, bytes([(cls << 4) | ident] + bits) + syms)
                       for (cls, ident), (bits, syms) in sorted(tables.items()))
        data = []
        for i, interval in enumerate(self.intervals):
            if i:
                data.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            if interval:
                value = [codes[k][0][s] if k is not None else s for k, s, _ in interval]
                length = [codes[k][1][s] if k is not None else n for k, s, n in interval]
                data.append(_pack_bits(np.asarray(value, np.int64), np.asarray(length, np.int64)))
        return dht, b"".join(data)


# T.81 Table D.2, the QM coder's probability estimation: (Qe, next index
# after an LPS, next index after an MPS, switch MPS), and the fixed 0.5
# estimate of T.851 as the last entry.
_QM_STATES = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0),
    (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1),
    (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0), (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0), (0x34EE, 91, 85, 0),
    (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0),
    (0x56A8, 95, 96, 1), (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504F, 111, 107, 0),
    (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]
# Per state: (Qe, next state after an LPS with the MPS switch in bit 7,
# next state after an MPS), the form the coder below reads.
_QM = [(qe, nl | (sw << 7), nm) for qe, nl, nm, sw in _QM_STATES]
_FIXED_STATE = 113


class _ArithScan:
    """A scan's arithmetic-coded data (T.81 Annex D's QM coder, with the
    statistics bins of Annex F and G as libjpeg's encoder keeps them), per
    restart interval. A statistics area is a bytearray of states: the
    index in bits 0-6, the MPS in bit 7."""

    def __init__(self, dc_tables, ac_tables, conditioning):
        (self.L, self.U), self.K = conditioning
        self.dc_stats = {t: bytearray(64) for t in dc_tables}
        self.ac_stats = {t: bytearray(256) for t in ac_tables}
        self.fixed = bytearray([_FIXED_STATE])
        self.out = bytearray()
        self.reset_coder()

    def reset_coder(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, byte):
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _pending_zeros(self):
        self.out.extend(bytes(self.zc))
        self.zc = 0

    def _byte_out(self, temp):
        """D.1.6's output of one byte, with the carry into stacked 0xFF
        bytes and the trailing zero bytes held back."""
        if temp > 0xFF:
            if self.buffer >= 0:
                self._pending_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc  # the carry turns the stacked 0xFF bytes to 0x00
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._pending_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._pending_zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
            self.buffer = temp & 0xFF

    def code(self, st, i, val):
        """Codes the decision ``val`` (0 or 1) with the estimate st[i]."""
        sv = st[i]
        qe, nl, nm = _QM[sv & 0x7F]
        a = self.a - qe
        if val != (sv >> 7):  # the less probable symbol
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                self._byte_out(c >> 19)
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def flush(self):
        """D.1.8's termination: the shortest tail that leaves the decoder
        inside the final interval (the decoder reads zeros past it)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._pending_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._pending_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._pending_zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._pending_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        self.zc = 0

    def restart(self, index, dc, ac):
        """Ends the interval with marker RST(index % 8); resets the DC
        statistics (and the predictions, by the caller) if ``dc``, the AC
        statistics if ``ac``."""
        self.flush()
        self.out.extend(bytes([0xFF, 0xD0 + index % 8]))
        if dc:
            for st in self.dc_stats.values():
                st[:] = bytes(64)
        if ac:
            for st in self.ac_stats.values():
                st[:] = bytes(256)
        self.reset_coder()

    def magnitude(self, st, v, bin_of):
        """F.1.4.3.1: the magnitude category of ``v`` - 1 (v >= 1), each
        category decision j on the bin ``bin_of(j)``, then its bits below
        the top one on the final decision's bin + 14; returns the
        category's top bit (0 for category 0)."""
        v -= 1
        n = v.bit_length()
        for j in range(n):
            self.code(st, bin_of(j), 1)
        last = bin_of(n)
        self.code(st, last, 0)
        for b in range(n - 2, -1, -1):
            self.code(st, last + 14, (v >> b) & 1)
        return 1 << (n - 1) if n else 0

    def dc(self, tbl, ctx, diff):
        """One DC difference (F.1.4.1); returns the next conditioning
        context."""
        st = self.dc_stats[tbl]
        if diff == 0:
            self.code(st, ctx, 0)
            return 0
        self.code(st, ctx, 1)
        sign = diff < 0
        self.code(st, ctx + 1, int(sign))
        s0 = ctx + 2 + sign  # the first decision on SP or SN, the rest on X1 (bin 20) on
        top = self.magnitude(st, abs(diff), lambda j: s0 if j == 0 else 19 + j)
        if top < (1 << self.L) >> 1:
            return 0
        return (12 if top > (1 << self.U) >> 1 else 4) + 4 * sign

    def ac(self, tbl, block, ss, se, al):
        """One block's AC band ss-se (F.1.4.2, G.1.3.2), each coefficient
        divided by 2^al toward zero."""
        st = self.ac_stats[tbl]
        vals = _ac_band(block, ss, se, al)
        ke = max((ss + i for i, v in enumerate(vals) if v), default=ss - 1)
        k = ss
        while k <= ke:
            base = 3 * (k - 1)
            self.code(st, base, 0)  # not the end of the block
            while vals[k - ss] == 0:
                self.code(st, base + 1, 0)
                base += 3
                k += 1
            self.code(st, base + 1, 1)
            v = vals[k - ss]
            self.code(self.fixed, 0, int(v < 0))
            s0, x2 = base + 2, 189 if k <= self.K else 217  # two decisions on S0 + 2, the rest on X2 on
            self.magnitude(st, abs(v), lambda j: s0 if j < 2 else x2 + j - 2)
            k += 1
        if k <= se:
            self.code(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, block, ss, se, al):
        """One block's AC refinement at bit al (G.1.3.3)."""
        st = self.ac_stats[tbl]
        now = [abs(v) >> al for v in block]
        ke = max((k for k in range(1, se + 1) if now[k]), default=0)
        kex = max((k for k in range(1, ke + 1) if now[k] >> 1), default=0)
        k = ss
        while k <= ke:
            base = 3 * (k - 1)
            if k > kex:
                self.code(st, base, 0)
            while True:
                if now[k]:
                    if now[k] >> 1:
                        self.code(st, base + 2, now[k] & 1)
                    else:
                        self.code(st, base + 1, 1)
                        self.code(self.fixed, 0, int(block[k] < 0))
                    break
                self.code(st, base + 1, 0)
                base += 3
                k += 1
            k += 1
        if k <= se:
            self.code(st, 3 * (k - 1), 1)


def _ac_band(block, ss, se, al):
    """The band's coefficients divided by 2^al toward zero."""
    return [(-((-v) >> al) if v < 0 else v >> al) for v in block[ss:se + 1]]


class _HuffmanProgressive:
    """jcphuff.c's coding of progressive scans into a :class:`_HuffmanScan`:
    DC first and refine, AC first and refine with EOB runs and correction
    bits."""

    def __init__(self, scan: _HuffmanScan):
        self.scan, self.eobrun, self.be = scan, 0, []

    def eob(self, tbl):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.scan.symbol((1, tbl), n << 4)
            self.scan.bits(self.eobrun, n)
            self.eobrun = 0
            for b in self.be:
                self.scan.bits(b, 1)
            self.be = []

    def ac_first(self, tbl, block, ss, se, al):
        r = 0
        for k, v in zip(range(ss, se + 1), _ac_band(block, ss, se, al)):
            if v == 0:
                r += 1
                continue
            self.eob(tbl)
            while r > 15:
                self.scan.symbol((1, tbl), 0xF0)
                r -= 16
            n = abs(v).bit_length()
            self.scan.symbol((1, tbl), (r << 4) + n)
            self.scan.bits(v if v > 0 else v - 1, n)
            r = 0
        if r:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.eob(tbl)

    def ac_refine(self, tbl, block, ss, se, al):
        absv = [abs(v) >> al for v in block[ss:se + 1]]
        last_new = max((ss + i for i, v in enumerate(absv) if v == 1), default=-1)
        r, br = 0, []
        for k, a in zip(range(ss, se + 1), absv):
            if a == 0:
                r += 1
                continue
            while r > 15 and k <= last_new:
                self.eob(tbl)
                self.scan.symbol((1, tbl), 0xF0)
                r -= 16
                for b in br:
                    self.scan.bits(b, 1)
                br = []
            if a > 1:
                br.append(a & 1)
                continue
            self.eob(tbl)
            self.scan.symbol((1, tbl), (r << 4) + 1)
            self.scan.bits(int(block[k] >= 0), 1)
            for b in br:
                self.scan.bits(b, 1)
            br, r = [], 0
        if r or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.eob(tbl)


def progressive_scans(components: int) -> List[Tuple[Tuple[int, ...], int, int, int, int]]:
    """libjpeg's default progressive script (jcparam.c
    jpeg_simple_progression) for 1 or 3 components, as (components, Ss,
    Se, Ah, Al) per scan; 4 components get one band split per component."""
    if components == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    all_c = tuple(range(components))
    scans = [(all_c, 0, 0, 0, 1)]
    scans += [((ci,), 1, 5, 0, 2) for ci in all_c] + [((ci,), 6, 63, 0, 2) for ci in all_c]
    scans += [((ci,), 1, 63, 2, 1) for ci in all_c] + [(all_c, 0, 0, 1, 0)]
    return scans + [((ci,), 1, 63, 1, 0) for ci in all_c]


def _scan_mcus(comps, factors, coefs, w, h):
    """The blocks of each MCU of a scan over ``comps``: one block per MCU
    over the component's own blocks for a single component, else whole
    MCUs of every component's blocks in turn."""
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    if len(comps) == 1:
        ci = comps[0]
        fh, fv = factors[ci]
        wib, hib = -(-(-(-w * fh // mh)) // 8), -(-(-(-h * fv // mv)) // 8)
        for by in range(hib):
            row = coefs[ci][by]
            for bx in range(wib):
                yield [(0, ci, row[bx])]
        return
    mcuy, mcux = -(-h // (8 * mv)), -(-w // (8 * mh))
    for my in range(mcuy):
        for mx in range(mcux):
            yield [(pos, ci, coefs[ci][my * factors[ci][1] + y][mx * factors[ci][0] + x])
                   for pos, ci in enumerate(comps) for y in range(factors[ci][1]) for x in range(factors[ci][0])]


def encode_jpeg_dct(img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0", coding: str = "huffman",
                    scans: Optional[Sequence] = None, restart_interval: int = 0,
                    conditioning: Optional[Tuple[Tuple[int, int], int]] = None, ycck: bool = False) -> bytes:
    """A DCT JPEG of ``img`` (as :func:`encode_jpeg` takes it) in another
    coding: ``coding`` "huffman" (tables made from each scan's own counts)
    or "arithmetic"; ``scans`` None for one sequential interleaved scan
    (SOF9; a sequential Huffman-coded file is :func:`encode_jpeg`'s), else a
    progressive script of (components, Ss, Se, Ah, Al) per scan (SOF2,
    SOF10; see :func:`progressive_scans`), which may leave
    any band unsent or unrefined; ``restart_interval`` MCUs per DRI
    interval; ``conditioning`` ((L, U), Kx) written as a DAC segment for
    every table (arithmetic only; default (0, 1), 5, which writes none)."""
    if coding not in ("huffman", "arithmetic"):
        raise ValueError(f"coding {coding!r}: huffman or arithmetic")
    if conditioning is not None and coding != "arithmetic":
        raise ValueError("conditioning (DAC) is for arithmetic coding")
    if coding == "huffman" and scans is None:
        raise ValueError("a sequential Huffman-coded file is encode_jpeg's")
    h, w, factors, tables, qtables, coefs = _quantised(img, quality, subsampling, ycck, "encode_jpeg_dct")
    c = len(factors)
    coefs = [q.tolist() for q in coefs]
    progressive = scans is not None
    scans = scans if progressive else [(tuple(range(c)), 0, 63, 0, 0)]
    sof = (0xCA if progressive else 0xC9) if coding == "arithmetic" else 0xC2
    out = [_jpeg_head(sof, h, w, factors, tables, qtables, _adobe(2) if ycck else _JFIF)]
    if conditioning is not None:
        (lo, up), kx = conditioning
        used = sorted(set(tables))
        out.append(_segment(0xCC, b"".join(bytes([t, (up << 4) | lo]) for t in used)
                            + b"".join(bytes([16 + t, kx]) for t in used)))
    if restart_interval:
        out.append(_segment(0xDD, restart_interval.to_bytes(2, "big")))
    for comps, ss, se, ah, al in scans:
        mode = "seq" if not progressive else ("dc" if ss == 0 else "ac") + ("_refine" if ah else "")
        ns = len(comps)
        last = [0] * ns
        if coding == "arithmetic":
            coder = _ArithScan({tables[ci] for ci in comps}, {tables[ci] for ci in comps},
                               conditioning or ((0, 1), 5))
            ctx = [0] * ns
        else:
            coder = _HuffmanScan()
            prog = _HuffmanProgressive(coder)
        for n, mcu in enumerate(_scan_mcus(comps, factors, coefs, w, h)):
            if restart_interval and n and n % restart_interval == 0:
                index = n // restart_interval - 1
                if coding == "arithmetic":
                    coder.restart(index, mode in ("seq", "dc"), mode != "dc" and mode != "dc_refine")
                    ctx = [0] * ns
                else:
                    prog.eob(tables[comps[0]])
                    coder.restart()
                last = [0] * ns
            for pos, ci, block in mcu:
                tbl = tables[ci]
                if mode in ("seq", "dc"):
                    v = block[0] >> al if mode == "dc" else block[0]
                    diff, last[pos] = v - last[pos], v
                    if coding == "arithmetic":
                        ctx[pos] = coder.dc(tbl, ctx[pos], diff)
                    else:
                        size = abs(diff).bit_length()
                        coder.symbol((0, tbl), size)
                        coder.bits(diff if diff >= 0 else diff - 1, size)
                    if mode == "seq":
                        coder.ac(tbl, block, 1, 63, 0)
                elif mode == "dc_refine":
                    if coding == "arithmetic":
                        coder.code(coder.fixed, 0, (block[0] >> al) & 1)
                    else:
                        coder.bits((block[0] >> al) & 1, 1)
                elif coding == "arithmetic":
                    (coder.ac if mode == "ac" else coder.ac_refine)(tbl, block, ss, se, al)
                else:
                    (prog.ac_first if mode == "ac" else prog.ac_refine)(tbl, block, ss, se, al)
        if coding == "arithmetic":
            coder.flush()
            head, data = b"", bytes(coder.out)
        else:
            prog.eob(tables[comps[0]])
            head, data = coder.finish()
        ids = b"".join(bytes([ci + 1, (tables[ci] << 4) | tables[ci]]) for ci in comps)
        out += [head, _segment(0xDA, bytes([ns]) + ids + bytes([ss, se, (ah << 4) | al])), data]
    out.append(b"\xff\xd9")
    return b"".join(out)


_PREDICTORS = {
    1: lambda a, b, c: a,
    2: lambda a, b, c: b,
    3: lambda a, b, c: c,
    4: lambda a, b, c: a + b - c,
    5: lambda a, b, c: a + ((b - c) >> 1),
    6: lambda a, b, c: b + ((a - c) >> 1),
    7: lambda a, b, c: (a + b) >> 1,
}


def encode_jpeg_lossless(img: np.ndarray, predictor: int = 1, point_transform: int = 0,
                         sampling: Optional[Sequence[Tuple[int, int]]] = None, restart_interval: int = 0,
                         app: Optional[str] = None, ids: Optional[Sequence[int]] = None,
                         interleaved: bool = True) -> bytes:
    """A lossless (SOF3, Huffman-coded) JPEG of ``img`` uint8 [H,W] or
    [H,W,C] (C = 1, 3 or 4), its samples stored as given (no colour
    transform), each divided by 2^``point_transform``: ``predictor`` 1-7
    (T.81 Table H.1), ``sampling`` the (h, v) factors of each component
    (default all (1, 1); a smaller one stores the box average), one
    interleaved scan for C > 1 (or one scan per component),
    ``restart_interval`` MCUs per DRI interval (a whole number of MCU
    rows), ``app`` "jfif", "adobe" (transform 0) or
    "none" (default: "adobe" for C > 1) and the component ``ids`` (default
    1 to C). Huffman tables made from the differences' own counts."""
    img = np.asarray(img, np.uint8)
    img = img[..., None] if img.ndim == 2 else img
    h, w, c = img.shape
    if c not in (1, 3, 4):
        raise ValueError(f"encode_jpeg_lossless: {c} channels (1, 3 or 4)")
    if predictor not in _PREDICTORS or not 0 <= point_transform < 8:
        raise ValueError(f"encode_jpeg_lossless: predictor {predictor} (1-7), point transform {point_transform} (0-7)")
    factors = list(sampling or [(1, 1)] * c)
    tables = [0] + [1] * (c - 1)
    app = app or ("adobe" if c > 1 else "none")
    out = [_jpeg_head(0xC3, h, w, factors, tables, None, {"jfif": _JFIF, "adobe": _adobe(0), "none": b""}[app], ids)]
    if restart_interval:
        out.append(_segment(0xDD, restart_interval.to_bytes(2, "big")))
    comp_ids = ids or list(range(1, c + 1))
    for comps in ([tuple(range(c))] if interleaved and c > 1 else [(ci,) for ci in range(c)]):
        out.append(_lossless_scan(img, comps, factors, tables, comp_ids, predictor, point_transform, restart_interval))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _lossless_scan(img, comps, factors, tables, comp_ids, predictor, point_transform, restart_interval) -> bytes:
    """One lossless scan over ``comps``: its DHT segments, SOS and data."""
    h, w, _ = img.shape
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    interleaved = len(comps) > 1
    if interleaved:
        mcux, mcuy = -(-w // mh), -(-h // mv)
    else:
        mcux, mcuy = -(-w * factors[comps[0]][0] // mh), -(-h * factors[comps[0]][1] // mv)
    if restart_interval % mcux:
        raise ValueError(f"encode_jpeg_lossless: restart interval {restart_interval} is not a whole number of "
                         f"MCU rows ({mcux} MCUs)")
    rows_per_interval = restart_interval // mcux
    values, order, table_of = [], [], []
    offset = 0
    for ci in comps:
        fh, fv = factors[ci]
        dsw, dsh = -(-w * fh // mh), -(-h * fv // mv)
        plane = img[..., ci].astype(np.int64)
        if (fh, fv) != (mh, mv):
            padded = np.pad(plane, ((0, dsh * (mv // fv) - h), (0, dsw * (mh // fh) - w)), mode="edge")
            plane = np.rint(padded.reshape(dsh, mv // fv, dsw, mh // fh).mean((1, 3))).astype(np.int64)
        x = plane >> point_transform
        rows, cols = (mcuy * fv, mcux * fh) if interleaved else (dsh, dsw)
        x = np.pad(x, ((0, rows - dsh), (0, cols - dsw)), mode="edge")
        ra, rb, rc = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
        ra[:, 1:], rb[1:], rc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
        pred = _PREDICTORS[predictor](ra, rb, rc)
        pred[:, 0] = rb[:, 0]
        mcu_row = np.arange(rows) // (fv if interleaved else 1)
        first = (np.arange(rows) % (fv if interleaved else 1) == 0) & (
            mcu_row % rows_per_interval == 0 if rows_per_interval else mcu_row == 0)
        pred[first, 1:] = ra[first, 1:]
        pred[first, 0] = 1 << (8 - point_transform - 1)
        diff = (x - pred) & 0xFFFF
        values.append(np.where(diff >= 0x8000, diff - 0x10000, diff).reshape(-1))
        if interleaved:
            ids = offset + np.arange(rows * cols).reshape(mcuy, fv, mcux, fh).transpose(0, 2, 1, 3)
            order.append(ids.reshape(mcuy * mcux, fv * fh))
        else:
            order.append(np.arange(rows * cols).reshape(-1, 1))
        table_of.append(np.full(rows * cols, tables[ci]))
        offset += rows * cols
    order = np.concatenate(order, axis=1).reshape(-1)
    diff, table = np.concatenate(values)[order], np.concatenate(table_of)[order]
    size, bits = _magnitude_bits(diff)
    extra = np.where(size == 16, 0, size)
    out = []
    code, length = np.zeros(len(diff), np.int64), np.zeros(len(diff), np.int64)
    for t in sorted({tables[ci] for ci in comps}):
        sel = table == t
        counts, symbols = _optimal_table(np.bincount(size[sel], minlength=256))
        out.append(_segment(0xC4, bytes([t] + counts) + symbols))
        codes, lengths = _canonical(counts, symbols)
        code[sel], length[sel] = codes[size[sel]], lengths[size[sel]]
    out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(bytes([comp_ids[ci], tables[ci] << 4]) for ci in comps)
                        + bytes([predictor, 0, point_transform])))
    per_mcu = sum(factors[ci][0] * factors[ci][1] for ci in comps) if interleaved else 1
    step = restart_interval * per_mcu if restart_interval else len(diff)
    for i, at in enumerate(range(0, len(diff), step)):
        if i:
            out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        sl = slice(at, at + step)
        out.append(_pack_bits((code[sl] << extra[sl]) | (bits[sl] & ((1 << extra[sl]) - 1)), length[sl] + extra[sl]))
    return b"".join(out)


def save_jpeg(path: str, img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0"):
    """Write ``img`` with :func:`encode_jpeg`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))


def _lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff codes it: a clear code first, codes of 9 to 12
    bits written most significant bit first and widened one code early,
    the table cleared when it reaches 4094 entries, an end code last."""
    codes, widths = [256], [9]
    table, nbits, free, prefix = {}, 9, 258, None
    for b in data:
        if prefix is None:
            prefix = b
            continue
        code = table.get(prefix << 8 | b)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(nbits)
        table[prefix << 8 | b], free, prefix = free, free + 1, b
        if free == 4094:
            codes.append(256)
            widths.append(nbits)
            table, nbits, free = {}, 9, 258
        elif free > (1 << nbits) - 1:
            nbits += 1
    if prefix is not None:
        codes.append(prefix)
        widths.append(nbits)
        free += 1
        nbits = 9 if free == 4094 else nbits + (free > (1 << nbits) - 1)
        if free == 4094:
            codes.append(256)
            widths.append(12)
    codes.append(257)
    widths.append(nbits)
    c, w = np.asarray(codes, np.uint32), np.asarray(widths)
    bits = (c[:, None] >> np.arange(11, -1, -1)) & 1
    return np.packbits(bits[np.arange(12)[None] >= 12 - w[:, None]].astype(np.uint8)).tobytes()


def _packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as
    literals, at most 128 bytes a header."""
    arr = np.frombuffer(data, np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], arr[1:] != arr[:-1]]))
    lengths = np.diff(np.append(starts, len(arr)))
    out, literal = bytearray(), bytearray()

    def flush():
        for i in range(0, len(literal), 128):
            part = literal[i:i + 128]
            out.extend(bytes([len(part) - 1]) + part)
        literal.clear()

    for start, length in zip(starts.tolist(), lengths.tolist()):
        if length < 3:
            literal.extend(data[start:start + length])
            continue
        flush()
        while length > 0:
            n = min(length, 128)
            if n < 3:
                literal.extend(data[start:start + n])
                break
            out.extend(bytes([257 - n, data[start]]))
            length -= n
    flush()
    return bytes(out)


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
_TIFF_COMPRESSION = {"none": 1, "lzw": 5, "adobe_deflate": 8, "packbits": 32773, "deflate": 32946}


def _predict(block: np.ndarray, predictor: int, samples: int) -> np.ndarray:
    """Rows [R, W*S] of samples with TIFF's predictor 2 (each sample minus
    the one S before it) or 3 (float32: the row's bytes as big-endian byte
    planes, each byte minus the one S before it) applied."""
    if predictor == 2:
        out = block.copy()
        out[:, samples:] = block[:, samples:] - block[:, :-samples]
        return out
    planes = block.astype(">f4").view(np.uint8).reshape(len(block), -1, 4).transpose(0, 2, 1).reshape(len(block), -1)
    out = planes.copy()
    out[:, samples:] = planes[:, samples:] - planes[:, :-samples]
    return out


def encode_tiff(img: np.ndarray, compression: str = "none", byteorder: str = "<", predictor: int = 1,
                tile: Optional[Tuple[int, int]] = None, rows_per_strip: Optional[int] = None, planar: int = 1,
                photometric: Optional[int] = None, extra_samples: Sequence[int] = (), bits: Optional[int] = None,
                colormap: Optional[np.ndarray] = None, orientation: Optional[int] = None, bigtiff: bool = False,
                fill_order: int = 1, **coded) -> bytes:
    """A TIFF of ``img`` [H,W,S] (uint8, uint16, int16, int32, uint32 or
    float32; SampleFormat from the dtype) in ``byteorder`` ("<" II, ">"
    MM), strips of ``rows_per_strip`` rows (default: about 8 KiB) or tiles
    of ``tile`` = (width, length) (multiples of 16, edge tiles padded),
    planar configuration 1 or 2, ``compression`` one of none, lzw,
    adobe_deflate, deflate, packbits, ``predictor`` 2 (integers) or 3
    (float32). ``bits`` 1, 2, 4 or 12 packs uint values most significant
    bit first. Photometric defaults to grey (MinIsBlack), RGB for 3 or more
    samples, or palette where ``colormap`` ([3, 2^bits] uint16) is given.
    The codings of data/tiff_encode.py (jpeg, zstd, lzma, ccitt_rle,
    ccitt_rlew, group3, group4, thunderscan) and YCbCr (``photometric=6``
    with ``ycbcr_subsampling``) are written there, with ``coded``'s options
    (see ``tiff_encode.encode``)."""
    if compression in tiff_encode.CODINGS or photometric == 6 or coded:
        return tiff_encode.encode(img, compression, byteorder, tile=tile, rows_per_strip=rows_per_strip,
                                  photometric=photometric, predictor=predictor, extra_samples=extra_samples, bits=bits,
                                  orientation=orientation, fill_order=fill_order, planar=planar, **coded)
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    bits = bits or img.dtype.itemsize * 8
    fmt = {"f": 3, "i": 2}.get(img.dtype.kind, 1)
    photometric = photometric if photometric is not None else (3 if colormap is not None else (2 if spp >= 3 else 1))
    packed = img.astype(img.dtype.newbyteorder(byteorder)) if bits % 8 == 0 else img
    per_plane = spp if planar == 1 else 1

    def row_bytes(block):  # [R, W, S] -> [R, bytes], each row padded to a byte
        if bits % 8 == 0:
            return block.reshape(len(block), -1).view(np.uint8)
        flat = block.reshape(len(block), -1).astype(np.uint32)
        b = (flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return np.packbits(b.reshape(len(block), -1).astype(np.uint8), axis=1)

    tw, tl = tile or (w, rows_per_strip or max(1, 8192 // max(1, w * per_plane * bits // 8)))
    chunks = []
    for plane in ([img] if planar == 1 else [img[..., s:s + 1] for s in range(spp)]):
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                block = plane[y:y + tl, x:x + tw]
                if tile:
                    block = np.pad(block, ((0, tl - len(block)), (0, tw - block.shape[1]), (0, 0)), mode="edge")
                flat = block.reshape(len(block), -1)
                if predictor == 3:
                    chunks.append(_predict(flat, 3, per_plane).tobytes())
                    continue
                if predictor == 2:
                    block = _predict(flat, 2, per_plane).reshape(block.shape)
                chunks.append(row_bytes(block.astype(packed.dtype) if bits % 8 == 0 else block).tobytes())
    codec = {"lzw": _lzw, "packbits": _packbits, "adobe_deflate": zlib.compress, "deflate": zlib.compress,
             "none": bytes}[compression]
    chunks = [codec(c) for c in chunks]
    if fill_order == 2:  # libtiff reverses the bits of the stored (compressed) bytes
        chunks = [_REVERSED[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [_TIFF_COMPRESSION[compression]]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    fields.update({322: (4, [tw]), 323: (4, [tl])} if tile else {278: (4, [tl])})
    for tag, value in ((266, fill_order if fill_order != 1 else None), (274, orientation),
                       (317, predictor if predictor != 1 else None)):
        if value is not None:
            fields[tag] = (3, [value])
    if extra_samples:
        fields[338] = (3, list(extra_samples))
    if fmt != 1:
        fields[339] = (3, [fmt] * spp)
    if colormap is not None:
        fields[320] = (3, np.asarray(colormap, np.uint16).reshape(-1).tolist())
    return tiff_encode.tiff_file(chunks, fields, byteorder, bigtiff, tile)


def _bmp_rle(rows: np.ndarray, rle4: bool) -> bytes:
    """RLE8 or RLE4 rows (bottom row first): runs of equal indices (or, in
    RLE4, of a repeated pair) as encoded runs, others as absolute runs of 3
    or more, each row ended by 00 00 and the image by 00 01."""
    out = bytearray()
    for row in (rows & 15 if rle4 else rows).tolist():
        i, n = 0, len(row)
        while i < n:
            j = i + 1
            while j < n and j - i < 255 and row[j] == row[i + (j - i) % 2 if rle4 else i]:
                j += 1
            if j - i >= 3 or n - i < 3:
                pair = row[i] << 4 | (row[i + 1] if j - i > 1 else 0)
                out += bytes([j - i, pair if rle4 else row[i]])
                i = j
                continue
            k = min(n, i + 254)
            part = row[i:k]
            if rle4:
                part = part + [0] * (len(part) % 2)
                part = [part[m] << 4 | part[m + 1] for m in range(0, len(part), 2)]
            out += bytes([0, k - i]) + bytes(part) + b"\0" * (len(part) % 2)
            i = k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def encode_bmp(img: np.ndarray, bits: int = 24, compression: str = "none", palette: Optional[np.ndarray] = None,
               header: int = 40, top_down: bool = False, masks: Optional[Sequence[int]] = None) -> bytes:
    """A BMP of ``img``: uint8 [H,W,3] RGB at 24 bits (or 32: BGRX, alpha
    in X where [H,W,4] is given), [H,W,3] or [H,W,4] through ``masks``
    (R, G, B, A bitfields; 16 or 32 bits) with ``compression="bitfields"``,
    or [H,W] indices at 1, 4 or 8 bits into
    ``palette`` ([N, 3] RGB), optionally RLE8 or RLE4 ("rle8", "rle4").
    ``header`` is 12 (OS/2 1.x), 40, 56 or 124 bytes; rows are bottom-up
    unless ``top_down``."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if compression == "bitfields":
        words = np.zeros((h, w), np.uint32)
        for c, m in enumerate(masks[:img.shape[-1]]):
            if m:
                shift = (m & -m).bit_length() - 1
                words |= ((img[..., c].astype(np.uint32) >> (8 - (m >> shift).bit_length())) << shift) & m
        pixels = words.astype("<u4").view(np.uint8).reshape(h, w, 4)[..., :bits // 8].reshape(h, -1)
    elif bits in (24, 32):  # BGR, or BGRX with alpha (if any) in X
        alpha = img[..., 3:] if img.shape[-1] == 4 else np.zeros((h, w, 1), np.uint8)
        pixels = np.concatenate([img[..., 2::-1]] + ([alpha] if bits == 32 else []), -1).reshape(h, -1)
    else:
        per = 8 // bits
        idx = np.pad(img.astype(np.uint8), ((0, 0), (0, -w % per)))
        pixels = (idx.reshape(h, -1, per) << (bits * np.arange(per - 1, -1, -1))).sum(-1).astype(np.uint8)
    rows = pixels[::-1] if not top_down else pixels
    if compression in ("rle8", "rle4"):
        data = _bmp_rle(img[::-1] if not top_down else img, compression == "rle4")
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        data = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    codes = {"none": 0, "rle8": 1, "rle4": 2, "bitfields": 3}
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, codes[compression], len(data),
                           2835, 2835, 0 if palette is None else len(palette), 0)
        if header > 40:
            info += struct.pack("<4I", *(list(masks or [0, 0, 0]) + [0] * 4)[:4]) + bytes(header - 56)
    table = b""
    if palette is not None:
        bgr = np.asarray(palette, np.uint8)[:, ::-1]
        table = (bgr if header == 12 else np.pad(bgr, ((0, 0), (0, 1)))).tobytes()
    if compression == "bitfields" and header == 40:
        table = struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(table)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + table + data


def encode_webp(img: np.ndarray, lossless: bool = False, alpha: str = "lossless", alpha_filter: str = "none",
                alpha_pre_processing: int = 0, alpha_options: Optional[dict] = None, vp8x: bool = False,
                metadata: bool = False, unknown_chunk: bool = False, canvas: Optional[Tuple[int, int]] = None,
                offset: Tuple[int, int] = (0, 0), **options) -> bytes:
    """A WebP file of uint8 [H,W,3] or [H,W,4] (data/webp_encode.py).
    Lossy (``encode_vp8``'s options: quality, filter, level, sharpness,
    partitions, segments, intra, bpred_share, bpred_modes, skip_proba,
    lf_delta, prob_updates, seed): an RGBA image's alpha goes to an ALPH
    chunk, ``alpha`` "raw" or "lossless", under ``alpha_filter`` ("none",
    "horizontal", "vertical", "gradient"), ``alpha_options`` the VP8L
    options of a lossless one. Lossless (``encode_vp8l``'s options:
    transforms, cache_bits, backrefs, meta_bits, transform_bits,
    predictor_modes, groups, shuffle_palette, seed). ``vp8x`` puts a VP8X
    chunk in front of a file that needs none; ``metadata`` adds ICCP, EXIF
    and XMP chunks (and ``vp8x``), ``unknown_chunk`` a chunk libwebp does
    not know. ``canvas`` = (W, H) makes an animation whose frame 0 is the
    image at ``offset`` (x, y, even) on that canvas, followed by a second
    frame over the whole canvas."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    has_alpha = img.shape[-1] == 4

    def frame_chunks(im):
        if lossless:
            return [webp_encode.chunk(b"VP8L", webp_encode.encode_vp8l(im, **options))]
        out = []
        if im.shape[-1] == 4:
            out.append(webp_encode.chunk(b"ALPH", webp_encode.encode_alph(
                im[..., 3], alpha, alpha_filter, alpha_pre_processing, **(alpha_options or {}))))
        return out + [webp_encode.chunk(b"VP8 ", webp_encode.encode_vp8(im[..., :3], **options))]

    head, tail = [], []
    if metadata:
        head.append(webp_encode.chunk(b"ICCP", b"\x00" * 37))
        tail += [webp_encode.chunk(b"EXIF", b"Exif\x00\x00II*\x00" + bytes(9)),
                 webp_encode.chunk(b"XMP ", b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")]
    if unknown_chunk:
        tail.append(webp_encode.chunk(b"ZZZZ", b"skipped"))
    flags = 0x20 | 0x08 | 0x04 if metadata else 0  # ICCP, EXIF, XMP
    if canvas is not None:
        cw, ch = canvas
        x, y = offset
        second = np.zeros((ch, cw, img.shape[-1]), np.uint8)
        second[..., :3] = 128
        if has_alpha:
            second[..., 3] = 255

        def anmf(im, fx, fy, blend):
            fh, fw = im.shape[:2]
            return webp_encode.chunk(b"ANMF", (fx // 2).to_bytes(3, "little") + (fy // 2).to_bytes(3, "little")
                                     + (fw - 1).to_bytes(3, "little") + (fh - 1).to_bytes(3, "little")
                                     + (100).to_bytes(3, "little") + bytes([blend]) + b"".join(frame_chunks(im)))

        body = [webp_encode.chunk(b"ANIM", struct.pack("<IH", 0xFF204060, 0)), anmf(img, x, y, 2), anmf(second, 0, 0, 0)]
        return webp_encode.riff([webp_encode.vp8x(flags | 0x02 | (0x10 if has_alpha else 0), cw, ch), *head, *body,
                                 *tail])
    body = frame_chunks(img)
    if not (vp8x or metadata or unknown_chunk or (has_alpha and not lossless)):
        return webp_encode.riff(body)
    return webp_encode.riff([webp_encode.vp8x(flags | (0x10 if has_alpha else 0), w, h), *head, *body, *tail])


def _opaque(img: np.ndarray) -> np.ndarray:
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)


def _rgba16(img: np.ndarray) -> np.ndarray:
    return np.concatenate([img.astype(np.uint16) * 257, np.full(img.shape[:2] + (1,), 65535, np.uint16)], -1)


# The codings a stand-in's frames can be written in (``image_format``),
# each (extension, writer of uint8 RGB [H,W,3]): PNG with every row
# filter, JPEG as a camera writes it (4:2:0, quality 90), and TIFF, BMP
# and WebP as capture pipelines write them (JPEG-in-TIFF as GDAL and
# scanner tools write it, YCbCr 4:2:0 or RGB; YCbCr 2x2 under LZW, which
# libtiff converts; Zstandard and LZMA).
FRAME_FORMATS = {
    "tiff": (".tif", lambda img: encode_tiff(img, "lzw", predictor=2)),
    "tiff_rgba16_lzw": (".tif", lambda img: encode_tiff(_rgba16(img), "lzw", byteorder=">", predictor=2,
                                                        extra_samples=(2,))),
    "tiff_deflate": (".tif", lambda img: encode_tiff(img, "adobe_deflate")),
    "tiff_tiled_packbits": (".tif", lambda img: encode_tiff(img, "packbits", tile=(96, 80))),
    "bmp": (".bmp", lambda img: encode_bmp(img)),
    "bmp_bitfields": (".bmp", lambda img: encode_bmp(
        np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1), 32, "bitfields", header=124,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))),
    "webp": (".webp", lambda img: encode_webp(img, quality=90, bpred_share=0.1)),
    "webp_alpha": (".webp", lambda img: encode_webp(_opaque(img), quality=90, bpred_share=0.1, partitions=2,
                                                    alpha_filter="gradient")),
    "webp_lossless": (".webp", lambda img: encode_webp(img, lossless=True)),
    "tiff_jpeg_ycbcr": (".tif", lambda img: encode_tiff(img, "jpeg", photometric=6)),
    "tiff_jpeg_rgb": (".tif", lambda img: encode_tiff(img, "jpeg")),
    "tiff_ycbcr_lzw": (".tif", lambda img: encode_tiff(img, "lzw", photometric=6, ycbcr_subsampling=(2, 2))),
    "tiff_zstd": (".tif", lambda img: encode_tiff(img, "zstd", predictor=2)),
    "tiff_lzma_rgba16": (".tif", lambda img: encode_tiff(_rgba16(img), "lzma", byteorder=">", predictor=2,
                                                         extra_samples=(2,))),
    "tiff_ojpeg": (".tif", lambda img: tiff_encode.ojpeg_encode(img, "tables", quality=90)),
    "jp2": (".jp2", lambda img: encode_jpeg2000(img, "jp2", mct=True)),
    "j2k": (".j2k", lambda img: encode_jpeg2000(img, "j2k")),
    # Pillow's cinema4k-24 layout (CPRL, two progression order changes in
    # the tile-part header), reversible; and the part-two syntax other
    # encoders write: sYCC with 4:2:0 chroma, every code-block style, an
    # ROI shift of the luma, two quality layers, packet headers in PPT.
    "j2k_poc": (".j2k", lambda img: encode_jpeg2000(img, "j2k", progression=4,
                                                    poc=jpeg2000_encode.CINEMA4K_POC)),
    "jp2_part_two": (".jp2", lambda img: encode_jpeg2000(img, "jp2", ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)],
                                                         style=0x3F, roi=[0], layers=2, packed="ppt")),
}
# The lossy codings: they do not read back to their source.
LOSSY_FORMATS = ("webp", "webp_alpha", "tiff_jpeg_ycbcr", "tiff_jpeg_rgb", "tiff_ycbcr_lzw", "tiff_ojpeg",
                 "jp2_part_two")


def _scan_starts(data: bytes) -> List[int]:
    """The offset of each scan's entropy-coded data in a JPEG."""
    starts, pos = [], data.find(b"\xff\xda")
    while pos >= 0:
        starts.append(pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big"))
        pos = data.find(b"\xff\xda", starts[-1])
    return starts


def _fixed_huffman_deflate(raw: bytes) -> Tuple[bytes, int]:
    """A zlib stream of ``raw`` as one final deflate block of literals under
    the fixed Huffman codes (RFC 1951 3.2.6), written here bit by bit so
    that its bytes do not depend on the host's zlib; and the bit offset of
    its end-of-block code."""
    codes = np.arange(256)
    # literals 0-143: 8 bits from 0x30; 144-255: 9 bits from 0x190; sent
    # first bit first, so reversed into the stream's least-significant-first bits
    value = np.where(codes < 144, codes + 0x30, codes - 144 + 0x190)
    length = np.where(codes < 144, 8, 9)
    rev = np.zeros(256, np.int64)
    for i in range(9):
        rev |= ((value >> i) & 1) << np.where(length == 8, 7 - i, 8 - i)
    rev[codes < 144] &= 0xFF
    data = np.frombuffer(raw, np.uint8)
    lens = length[data]
    starts = 3 + np.concatenate([[0], np.cumsum(lens)[:-1]])  # BFINAL, BTYPE=01 first
    eob = 3 + int(lens.sum())
    nbits = eob + 7
    bits = np.zeros(nbits + 7, np.uint8)
    bits[0], bits[1] = 1, 1  # BFINAL 1, BTYPE 01 (least significant bit first)
    for k in range(9):
        has = lens > k
        bits[starts[has] + k] = (rev[data[has]] >> k) & 1
    stream = np.packbits(bits[:(nbits + 7) // 8 * 8].reshape(-1, 8)[:, ::-1], axis=1).ravel().tobytes()
    adler = zlib.adler32(raw) & 0xFFFFFFFF
    return b"\x78\x01" + stream + struct.pack(">I", adler), 16 + eob


def damaged_frames(size: int = 512, seed: int = 0) -> Dict[str, Tuple[str, bytes]]:
    """{name: (file extension, bytes)}: frames of ``camera_frame(seed + k,
    (size, size))`` damaged as a capture's frames get damaged, each of which
    Pillow reads (tests/test_torch_image_decode.py holds them to Pillow's
    recorded reading, tests/torch_image_corpus/manifest.json's
    ``damaged_frames``):

    - "jpeg_cut_eoi": a baseline JPEG (4:2:0, quality 90) cut halfway
      through its scan and closed with EOI;
    - "jpeg_stray_rst": one with an RST marker written over two bytes in
      the middle of its scan (it has no restart interval);
    - "jpeg_progressive_bad_code": a progressive JPEG (libjpeg's default
      script) with three stuffed 0xFF bytes written into the middle of
      its second scan, 24 one bits that no Huffman code starts with;
    - "png_damaged_tail": a PNG whose deflate stream (fixed Huffman codes)
      has its end-of-block code turned into a length code, after the last
      row.
    """
    frames = {}
    img = camera_frame(seed, (size, size))
    data = encode_jpeg(img, 90, "4:2:0")
    start = _scan_starts(data)[0]
    frames["jpeg_cut_eoi"] = (".jpg", data[:(start + len(data)) // 2] + b"\xff\xd9")
    img = camera_frame(seed + 1, (size, size))
    data = bytearray(encode_jpeg(img, 90, "4:2:0"))
    at = (_scan_starts(bytes(data))[0] + len(data)) // 2
    data[at:at + 2] = b"\xff\xd3"
    frames["jpeg_stray_rst"] = (".jpg", bytes(data))
    img = camera_frame(seed + 2, (size, size))
    data = encode_jpeg_dct(img, 90, "4:2:0", scans=progressive_scans(3))
    starts = _scan_starts(data)
    at = (starts[1] + data.find(b"\xff\xda", starts[1])) // 2
    frames["jpeg_progressive_bad_code"] = (".jpg", data[:at] + b"\xff\x00" * 3 + data[at + 6:])
    img = camera_frame(seed + 3, (size, size))
    rows = np.concatenate([np.zeros((size, 1), np.uint8), img.reshape(size, -1)], 1).tobytes()
    stream, eob = _fixed_huffman_deflate(rows)
    stream = bytearray(stream)
    stream[(eob + 6) // 8] ^= 1 << ((eob + 6) % 8)  # the code's last bit: 0000000 (256) -> 0000001 (257)
    header = struct.pack(">IIBBBBB", size, size, 8, 2, 0, 0, 0)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    frames["png_damaged_tail"] = (".png", b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", bytes(stream))
                                  + chunk(b"IEND", b""))
    return frames


def encode_jpeg2000(img: np.ndarray, container: str = "jp2", **options) -> bytes:
    """A lossless JPEG 2000 frame of ``img`` in Pillow's default layout
    (data/jpeg2000_encode.py): a JP2 file, or with ``container`` "j2k" a raw
    codestream; ``options``: those of jpeg2000_encode.encode_j2k."""
    return jpeg2000_encode.encode_jpeg2000(img, container, **options)


def _writer(data_of: Callable[[np.ndarray], bytes]) -> Saver:
    def save(path, img):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data_of(img))

    return save


def _saver(save: Optional[Saver], image_format: str, seed: int) -> Saver:
    """``save``, or the default writer of ``image_format``: PNG with every
    row filter, JPEG as a camera writes it (4:2:0, quality 90), or one of
    FRAME_FORMATS' TIFF, BMP, WebP and JPEG 2000 codings."""
    if image_format not in ("png", "jpeg", *FRAME_FORMATS):
        raise ValueError(f"image_format {image_format!r}: png, jpeg or one of {sorted(FRAME_FORMATS)}")
    if save:
        return save
    if image_format in FRAME_FORMATS:
        return _writer(FRAME_FORMATS[image_format][1])
    return save_jpeg if image_format == "jpeg" else filtered_saver(seed)


def _extension(image_format: str) -> str:
    return {"png": ".png", "jpeg": ".jpg"}.get(image_format) or FRAME_FORMATS[image_format][0]


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _render(pose_w2c, intr, light_pos, raw_hw, scale, render_div, bg, rng):
    """The cluttered scene seen by ``pose_w2c`` (world units divided by
    ``scale``), rendered at 1/``render_div`` of ``raw_hw`` and repeated up
    to it, lit by a point light with some ambient light. Returns (image,
    reflectance, shading, mask), float32 at ``raw_hw``."""
    H, W = raw_hw
    h, w = -(-H // render_div), -(-W // render_div)
    pose = pose_w2c.copy()
    pose[:, 3] /= scale
    small = intr.copy()
    small[:2] /= render_div
    _, ref, sha, mask = render_cluttered_image(pose, small, light_pos / scale, (h, w), white_background=False)
    sha = 0.2 + 0.8 * sha
    img = ref * sha * mask + bg * (1 - mask)

    def up(x):
        return np.repeat(np.repeat(x, render_div, 0), render_div, 1)[:H, :W]

    noise = rng.normal(0.0, 1.5 / 255.0, (H, W, 1)).astype(np.float32)
    return up(img) + noise, up(ref), up(sha), up(mask)


def write_rene(root: str, annotation_dir: str, cameras: int = 4, lights: int = 4,
               raw_size: Optional[Tuple[int, int]] = None, extra_splits: Dict[str, int] = None,
               save: Optional[Saver] = None, seed: int = 0) -> Dict[str, str]:
    """A ReNe scene under ``root``: ``train_transforms.json`` with the
    frames of ``cameras`` x ``lights`` of ``annotation_dir``'s train split
    (spread over its camera and light indices), ``val_transforms.json`` with
    every frame of its val split (savannah's holds ``c25l10``), and for each
    ``extra_splits`` entry (e.g. ``{"test_custom": 2}``) that many frames of
    ``<name>_transforms.json``. Images go to each frame's ``file_path`` at
    ``raw_size`` = (W, H) (default: the annotation's), intrinsics scaled to
    match. Returns {split: annotation path}."""
    save = save or filtered_saver(seed)
    rng = np.random.default_rng(seed)

    def meta_of(split):
        with open(os.path.join(annotation_dir, f"{split}_transforms.json")) as f:
            return json.load(f)

    train = meta_of("train")
    cams = sorted({f["camera_index"] for f in train["frames"]})
    lits = sorted({f["light_index"] for f in train["frames"]})
    pick_c = {cams[i] for i in np.linspace(0, len(cams) - 1, cameras).round().astype(int)}
    pick_l = {lits[i] for i in np.linspace(0, len(lits) - 1, lights).round().astype(int)}
    splits = {"train": dict(train, frames=[f for f in train["frames"]
                                           if f["camera_index"] in pick_c and f["light_index"] in pick_l])}
    splits["val"] = meta_of("val")
    for name, count in (extra_splits or {}).items():
        meta = meta_of(name)
        splits[name] = dict(meta, frames=meta["frames"][:count])
    os.makedirs(root, exist_ok=True)
    written, out = set(), {}
    for split, meta in splits.items():
        raw_w, raw_h = raw_size or (meta["w"], meta["h"])
        sx, sy = raw_w / meta["w"], raw_h / meta["h"]
        meta = dict(meta, w=raw_w, h=raw_h, fl_x=meta["fl_x"] * sx, cx=meta["cx"] * sx, sk_x=meta["sk_x"] * sx,
                    fl_y=meta["fl_y"] * sy, cy=meta["cy"] * sy)
        intr = np.asarray([[meta["fl_x"], meta["sk_x"], meta["cx"]],
                           [meta.get("sk_y", 0.0), meta["fl_y"], meta["cy"]], [0, 0, 1]], np.float32)
        for frame in meta["frames"]:
            path = os.path.normpath(os.path.join(root, frame["file_path"]))
            if path in written:
                continue
            pose = invert_pose(gl_to_cv(np.asarray(frame["transform_matrix"], np.float32))[:3])
            light = np.asarray(frame["transform_matrix_light"], np.float32)[:3, 3]
            img, _, _, _ = _render(pose, intr, light, (raw_h, raw_w), RENE_SCENE_SCALE, RENE_RENDER_DIV, 0.15, rng)
            save(path, _to_uint8(img))
            written.add(path)
        out[split] = os.path.join(root, f"{split}_transforms.json")
        with open(out[split], "w") as f:
            json.dump(meta, f)
    return out


def _ring_frames(count: int, lights: int, rng: np.random.Generator, offset: float) -> List[dict]:
    frames = []
    for i in range(count):
        phi = 2 * np.pi * i / count + offset
        elev = rng.uniform(0.3, 0.7)
        cam = 2.4 * np.asarray([np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev), np.sin(elev)], np.float32)
        w2c = look_at_pose(cam)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = w2c[:, :3].T
        c2w[:3, 3] = cam
        li = i % lights
        phi_l = 2 * np.pi * li / lights + 0.4
        light = 1.9 * np.asarray([np.cos(phi_l) * 0.6, np.sin(phi_l) * 0.6, 0.8], np.float32)
        frames.append(dict(transform_matrix=gl_to_cv(c2w).tolist(), pl_pos=light.tolist(), pl_index=li))
    return frames


def _formats(image_format, split: str, count: int) -> List[str]:
    """The format of each of a split's ``count`` frames: ``image_format`` is
    one format, a sequence cycled over the frames, or a dict of either by
    split."""
    fmt = image_format.get(split, "png") if isinstance(image_format, dict) else image_format
    return [fmt] * count if isinstance(fmt, str) else [fmt[i % len(fmt)] for i in range(count)]


def write_point_light(root: str, image_size: int = 512, train: int = 4, val: int = 2, lights: int = 2,
                      source: str = "mli", save: Optional[Saver] = None, seed: int = 0,
                      image_format="png") -> Dict[str, str]:
    """A point-light scene under ``root``, ``transforms_{train,val}.json``
    with ``pl_pos`` per frame. ``source="mli"``: the MLI-synthetic layout,
    ``camera_angle_x`` and RGBA ``<file_path>{Img,Ref,Sha,Res}.png`` (alpha
    = coverage); ``source="nrhints"``: NRHints', ``camera_intrinsics`` and
    one RGB ``<file_path><file_ext>`` per frame, ``file_ext`` that of its
    format: ".png", ".jpg" for "jpeg", or ".tif"/".bmp"/".webp" for FRAME_FORMATS'
    codings. ``image_format`` is one format, a sequence of them cycled over
    each split's frames, or a dict of either by split. Returns {split:
    annotation path}."""
    formats = {split: _formats(image_format, split, n) for split, n in (("train", train), ("val", val))}
    if source != "nrhints" and {f for v in formats.values() for f in v} != {"png"}:
        raise ValueError(f"image_format={image_format!r} is NRHints' layout (source='nrhints'); MLI's frames are "
                         "RGBA PNGs")
    savers = {f: _saver(save, f, seed) for v in formats.values() for f in v}
    rng = np.random.default_rng(seed)
    angle_x = 0.69
    focal = 0.5 * image_size / np.tan(0.5 * angle_x)
    intr = np.asarray([[focal, 0, image_size / 2], [0, focal, image_size / 2], [0, 0, 1]], np.float32)
    out = {}
    for split, count, offset in (("train", train, 0.0), ("val", val, 0.3)):
        frames = _ring_frames(count, lights, rng, offset)
        for i, frame in enumerate(frames):
            pose = invert_pose(gl_to_cv(np.asarray(frame["transform_matrix"], np.float32))[:3])
            img, ref, sha, mask = _render(pose, intr, np.asarray(frame["pl_pos"], np.float32),
                                          (image_size, image_size), 1.0, 1, 0.0, rng)
            if source == "nrhints":
                fmt = formats[split][i]
                frame.update(file_path=f"{split}/{i:03d}", file_ext=_extension(fmt))
                savers[fmt](os.path.join(root, frame["file_path"] + frame["file_ext"]), _to_uint8(img))
                continue
            frame["file_path"] = f"{split}/{i:03d}_"
            alpha = _to_uint8(mask)
            res = np.zeros_like(ref)
            for key, value in (("Img", img), ("Ref", ref), ("Sha", sha), ("Res", res)):
                rgb = _to_uint8(np.broadcast_to(value, ref.shape))
                savers["png"](os.path.join(root, frame["file_path"] + key + ".png"), np.concatenate([rgb, alpha], -1))
        meta = dict(frames=frames)
        if source == "nrhints":
            meta["camera_intrinsics"] = [image_size / 2, image_size / 2, float(focal), float(focal)]
        else:
            meta["camera_angle_x"] = angle_x
        out[split] = os.path.join(root, f"transforms_{split}.json")
        os.makedirs(root, exist_ok=True)
        with open(out[split], "w") as f:
            json.dump(meta, f)
    return out


def write_nerf_synthetic(root: str, image_size: int = 800, train: int = 4, val: int = 2, render_div: int = 4,
                         save: Optional[Saver] = None, seed: int = 0) -> Dict[str, str]:
    """A NeRF-synthetic scene under ``root`` in lego's layout:
    ``transforms_{train,val}.json`` with ``camera_angle_x`` and each
    frame's OpenGL ``transform_matrix``, and RGBA ``<file_path>.png`` at
    ``image_size`` (lego's raw 800x800; alpha = coverage) on cameras at
    radius 4 around the origin (lego's). Returns {split: annotation path}."""
    save = save or filtered_saver(seed)
    rng = np.random.default_rng(seed)
    angle_x = 0.6911112070083618  # lego's
    focal = 0.5 * image_size / np.tan(0.5 * angle_x)
    intr = np.asarray([[focal, 0, image_size / 2], [0, focal, image_size / 2], [0, 0, 1]], np.float32)
    os.makedirs(root, exist_ok=True)
    out = {}
    for split, count, offset in (("train", train, 0.0), ("val", val, 0.3)):
        frames = []
        for i in range(count):
            phi, elev = 2 * np.pi * i / count + offset, rng.uniform(0.2, 0.8)
            cam = 4.0 * np.asarray([np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev), np.sin(elev)], np.float32)
            w2c = look_at_pose(cam)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3], c2w[:3, 3] = w2c[:, :3].T, cam
            light = cam + np.asarray([0.0, 0.0, 2.0], np.float32)
            img, _, _, mask = _render(w2c, intr, light, (image_size, image_size), 1.0, render_div, 0.0, rng)
            frame = dict(file_path=f"./{split}/r_{i}", transform_matrix=gl_to_cv(c2w).tolist())
            save(os.path.join(root, frame["file_path"] + ".png"),
                 np.concatenate([_to_uint8(img), _to_uint8(mask)], -1))
            frames.append(frame)
        out[split] = os.path.join(root, f"transforms_{split}.json")
        with open(out[split], "w") as f:
            json.dump(dict(camera_angle_x=angle_x, frames=frames), f)
    return out


def write_llff(root: str, raw_size: Tuple[int, int] = (1008, 756), frames: int = 9, render_div: int = 4,
               save: Optional[Saver] = None, seed: int = 0, image_format: str = "png") -> str:
    """A forward-facing scene under ``root`` in fern's layout:
    ``poses_bounds.npy`` ([N,17]: the [down, right, back, t] columns, then
    (H, W, focal) at ``raw_size`` = (W, H), then the near and far bounds)
    and ``images/IMG_<i>.png``, or ``IMG_<i>.JPG`` (fern's) with
    ``image_format="jpeg"``. The cameras sit on a small grid 4 units in
    front of the scene, all looking along -z, so every ray goes forward
    after the loader's recentring (NDC needs z > 0). Returns ``root``."""
    save = _saver(save, image_format, seed)
    ext = ".JPG" if image_format == "jpeg" else ".png"
    rng = np.random.default_rng(seed)
    raw_w, raw_h = raw_size
    focal = 0.8 * raw_w
    intr = np.asarray([[focal, 0, raw_w / 2], [0, focal, raw_h / 2], [0, 0, 1]], np.float32)
    right, up, back = np.eye(3, dtype=np.float32)
    rows = []
    for i in range(frames):
        cam = np.asarray([0.3 * (i % 3 - 1), 0.2 * (i // 3 - 1), 4.0], np.float32) + rng.normal(0, 0.02, 3)
        c2w_cv = np.stack([right, -up, -back, cam], axis=1)  # [right, down, forward, t]
        img, _, _, _ = _render(invert_pose(c2w_cv), intr, cam + np.asarray([1.0, 2.0, 0.0], np.float32),
                               (raw_h, raw_w), 1.0, render_div, 0.15, rng)
        save(os.path.join(root, "images", f"IMG_{4026 + i}{ext}"), _to_uint8(img))
        stored = np.stack([-up, right, back, cam], axis=1)
        hwf = np.asarray([[raw_h], [raw_w], [focal]], np.float64)
        near = 2.4 + rng.uniform(0, 0.2)
        rows.append(np.concatenate([np.concatenate([stored, hwf], axis=1).reshape(-1), [near, 6.0 + near]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.asarray(rows, np.float64))
    return root
