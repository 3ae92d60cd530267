"""The fixtures' JPEG 2000 encoder: reversible 5/3 frames in the layout
Pillow's writer (openjpeg 2.5) gives by default (LRCP, one quality layer,
up to 5 decomposition levels, 64x64 code-blocks of style 0, one precinct
per resolution, guard bits 2, no quantisation), with the RCT on request
(``mct``), as a JP2 file or a raw codestream. Options Pillow's writer has
no way to ask for cover the rest of the decoder's packet syntax: SOP and
EPH markers, a tile split into tile-parts, a TLM marker, a component's own
COC and QCC.

The wavelet and tier 1 run in ``csrc/jpeg2000_encode.cpp`` (g++, built at
first use); tier 2 (tag trees, packet headers) and the markers and boxes
are here. Every frame is lossless: Pillow reads it back to its source.
It writes the stand-ins' frames and the tests' files; no loader reads
through it.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, Tuple

import numpy as np

_LIB = None
_LOCK = threading.Lock()


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("jpeg2000_encode")
            lib.j2k_fdwt53.restype = None
            lib.j2k_fdwt53.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.j2k_t1_encode.restype = ctypes.c_int64
            lib.j2k_t1_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            _LIB = lib
        return _LIB


class _Bits:
    """Packet-header bits (openjpeg's bio.c): MSB first, a 0 bit stuffed
    after each 0xFF byte."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((value >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    """opj_tgt_encode's tag tree over w x h leaves."""

    def __init__(self, w: int, h: int, values):
        self.parent, self.value, self.low, self.known = [], [], [], []
        levels, first = [(w, h)], [0]
        while levels[-1][0] * levels[-1][1] > 1:
            first.append(first[-1] + levels[-1][0] * levels[-1][1])
            levels.append(((levels[-1][0] + 1) // 2, (levels[-1][1] + 1) // 2))
        total = first[-1] + levels[-1][0] * levels[-1][1]
        self.parent, self.value = [-1] * total, [999] * total
        self.low, self.known = [0] * total, [False] * total
        for lvl in range(len(levels) - 1):
            lw, lh = levels[lvl]
            for y in range(lh):
                for x in range(lw):
                    self.parent[first[lvl] + y * lw + x] = first[lvl + 1] + (y // 2) * levels[lvl + 1][0] + x // 2
        for leaf, v in enumerate(values):
            node = leaf
            while node >= 0 and self.value[node] > v:
                self.value[node] = v
                node = self.parent[node]

    def encode(self, bits: _Bits, leaf: int, threshold: int):
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.put(1, 1)
                        self.known[node] = True
                    break
                bits.put(0, 1)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _num_passes(bits: _Bits, n: int):
    if n == 1:
        bits.put(0, 1)
    elif n == 2:
        bits.put(2, 2)
    elif n <= 5:
        bits.put(0xC | (n - 3), 4)
    elif n <= 36:
        bits.put(0x1E0 | (n - 6), 9)
    else:
        bits.put(0xFF80 | (n - 37), 16)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _bands(w: int, h: int, levels: int) -> List[List[Tuple[int, int, int, int, int]]]:
    """Per resolution, its bands as (orientation, x, y, width, height) in
    the transformed component (origin 0)."""
    sizes = [(-(-w // (1 << (levels - r))), -(-h // (1 << (levels - r)))) for r in range(levels + 1)]
    out = [[(0, 0, 0, *sizes[0])]]
    for r in range(1, levels + 1):
        (pw, ph), (rw, rh) = sizes[r - 1], sizes[r]
        out.append([(1, pw, 0, rw - pw, ph), (2, 0, ph, pw, rh - ph), (3, pw, ph, rw - pw, rh - ph)])
    return out


def _packet(plane, bands, sop: bool, eph: bool, index: int, cblk: int, guard: int) -> bytes:
    """One packet (layer 0, one precinct) of a resolution's bands of one
    component: ``cblk`` x ``cblk`` code-blocks, ``guard`` guard bits."""
    lib = _lib()
    bits = _Bits()
    blocks, body = [], []
    for orient, bx, by, bw, bh in bands:
        if bw <= 0 or bh <= 0:
            continue
        cw, ch = -(-bw // cblk), -(-bh // cblk)
        coded = []
        for k in range(cw * ch):
            x0, y0 = bx + (k % cw) * cblk, by + (k // cw) * cblk
            w, h = min(cblk, bx + bw - x0), min(cblk, by + bh - y0)
            block = np.ascontiguousarray(plane[y0:y0 + h, x0:x0 + w])
            out = np.empty(w * h * 8 + 64, np.uint8)
            info = np.zeros(2, np.int64)
            n = lib.j2k_t1_encode(block.ctypes.data, w, w, h, orient, out.ctypes.data, out.size, info.ctypes.data)
            if n < 0:
                raise RuntimeError("jpeg2000_encode: a code-block outgrew its buffer")
            coded.append((int(info[0]), int(info[1]), out[:n].tobytes()))
        blocks.append((orient, cw, ch, coded))
    bits.put(1, 1)
    for orient, cw, ch, coded in blocks:
        # Reversible: the band's Mb (E-2) is its exponent + guard bits - 1,
        # and a code-block of k bit planes has Mb - k zero bit planes.
        expn = 8 + (0 if orient == 0 else 2 if orient == 3 else 1)
        incl = _TagTree(cw, ch, [0 if passes else 999 for _, passes, _ in coded])
        imsb = _TagTree(cw, ch, [expn + guard - 1 - k for k, _, _ in coded])
        for i, (k, passes, data) in enumerate(coded):
            incl.encode(bits, i, 1)
            if not passes:
                continue
            imsb.encode(bits, i, 999)
            _num_passes(bits, passes)
            need = max(len(data).bit_length(), 1)
            floor = passes.bit_length() - 1
            increment = max(0, need - (3 + floor))
            bits.put((1 << (increment + 1)) - 2, increment + 1)  # increment 1s, then a 0
            bits.put(len(data), 3 + increment + floor)
            body.append(data)
    head = bits.flush()
    return ((_segment(0xFF91, struct.pack(">H", index & 0xFFFF)) if sop else b"") + head
            + (b"\xff\x92" if eph else b"") + b"".join(body))


def _steps(levels: int, guard: int) -> bytes:
    """Sqcd/Sqcc and the reversible exponents: 8 bits plus each band's gain."""
    return bytes([guard << 5]) + bytes([(8 + g) << 3 for g in [0] + [1, 1, 2] * levels])


def encode_j2k(img: np.ndarray, mct: bool = False, sop: bool = False, eph: bool = False, tile_parts: int = 1,
               tlm: bool = False, coc: bool = False, qcc: bool = False) -> bytes:
    """A lossless codestream of uint8 [H,W] or [H,W,C] (C 1-4); ``mct``
    (three or more channels) codes the first three through the RCT; ``coc``
    gives the last channel a COC (one decomposition level fewer, 32x32
    code-blocks), ``qcc`` a QCC (3 guard bits)."""
    img = np.asarray(img, np.uint8)
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    top = 5
    while top and min(w, h) < (1 << top):  # openjpeg's writer wants 2^levels samples (Pillow lowers it)
        top -= 1
    levels, cblk, guard = [top] * nc, [64] * nc, [2] * nc
    if coc:
        levels[-1], cblk[-1] = max(top - 1, 0), 32
    if qcc:
        guard[-1] = 3
    planes = [img[..., c].astype(np.int32) - 128 for c in range(nc)]
    if mct:
        r, g, b = planes[:3]
        planes[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    lib = _lib()
    for p, lv in zip(planes, levels):
        lib.j2k_fdwt53(p.ctypes.data, w, h, lv)
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + bytes([7, 1, 1]) * nc
    scod = (2 if sop else 0) | (4 if eph else 0)
    cod = struct.pack(">BBHB", scod, 0, 1, int(mct)) + bytes([top, 4, 4, 0, 1])
    main = b"\xff\x4f" + _segment(0xFF51, siz) + _segment(0xFF52, cod) + _segment(0xFF5C, _steps(top, 2))
    if coc:
        main += _segment(0xFF53, bytes([nc - 1, 0, levels[-1], 3, 3, 0, 1]))
    if qcc:
        main += _segment(0xFF5D, bytes([nc - 1]) + _steps(levels[-1], guard[-1]))
    packets, index = [], 0
    bands = [_bands(w, h, lv) for lv in levels]
    for r in range(top + 1):
        for c in range(nc):
            if r <= levels[c]:
                packets.append(_packet(planes[c], bands[c][r], sop, eph, index, cblk[c], guard[c]))
                index += 1
    # Tile-parts: whole packets each, as even a share as the packets allow.
    cuts = [round(i * len(packets) / tile_parts) for i in range(tile_parts + 1)]
    parts = [b"".join(packets[a:b]) for a, b in zip(cuts, cuts[1:])]
    tiles = b"".join(_segment(0xFF90, struct.pack(">HIBB", 0, 12 + 2 + len(data), i, tile_parts)) + b"\xff\x93" + data
                     for i, data in enumerate(parts))
    if tlm:
        main += _segment(0xFF55, bytes([0, 0x50]) + b"".join(struct.pack(">BI", 0, 14 + len(d)) for d in parts))
    return main + tiles + b"\xff\xd9"


def jp2(codestream: bytes, channels: int) -> bytes:
    """A JP2 file around a codestream of 8-bit unsigned channels: the
    signature, ftyp, jp2h (ihdr, colr: sRGB for three or four channels,
    greyscale for one or two) and jp2c boxes."""
    w, h = struct.unpack_from(">II", codestream, 8)  # Xsiz, Ysiz (the image origin is 0)

    def box(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body) + 8) + kind + body

    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, channels, 7, 7, 0, 0))
    colr = box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16 if channels >= 3 else 17))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ") + box(b"jp2h", ihdr + colr)
            + box(b"jp2c", codestream))


def encode_jpeg2000(img: np.ndarray, container: str = "jp2", **options) -> bytes:
    """``img`` as a JP2 file (``container`` "jp2") or a raw codestream
    ("j2k"); ``options`` go to :func:`encode_j2k`."""
    cs = encode_j2k(img, **options)
    if container == "j2k":
        return cs
    if container != "jp2":
        raise ValueError(f"container {container!r}: jp2 or j2k")
    return jp2(cs, 1 if np.ndim(img) == 2 else np.shape(img)[-1])
