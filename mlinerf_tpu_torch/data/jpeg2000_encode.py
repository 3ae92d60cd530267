"""The fixtures' JPEG 2000 encoder: reversible 5/3 frames in the layout
Pillow's writer (openjpeg 2.5) gives by default (LRCP, one quality layer,
up to 5 decomposition levels, 64x64 code-blocks of style 0, one precinct
per resolution, guard bits 2, no quantisation), with the RCT on request
(``mct``), as a JP2 file or a raw codestream. Options Pillow's writer has
no way to ask for cover the rest of the decoder's syntax: SOP and EPH
markers, a tile split into tile-parts, a TLM marker, a component's own COC
and QCC, code-block styles, quality layers, progression order changes
(POC), a region of interest (RGN), subsampled components and packed packet
headers (PPM, PPT).

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
from typing import List, Optional, Sequence, Tuple

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
            lib.j2k_t1_encode.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 6 + [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
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


def _roi(bands):
    """The region of interest in a component's coefficients (its Mallat
    layout): the middle half of each band, across and down."""
    h = max(by + bh for res in bands for _, _, by, _, bh in res)
    w = max(bx + bw for res in bands for _, bx, _, bw, _ in res)
    mask = np.zeros((h, w), bool)
    for res in bands:
        for _, bx, by, bw, bh in res:
            mask[by + bh // 4:by + bh - bh // 4, bx + bw // 4:bx + bw - bw // 4] = True
    return mask


def _max_shift(plane, mask) -> int:
    """RGN's max-shift for a component: one more than the bit length of its
    largest coefficient outside the region (openjpeg compares its doubled
    values with 2^shift)."""
    background = np.abs(plane[~mask]).max(initial=0)
    return int(background).bit_length() + 1


def _coded_bands(plane, bands, cblk: int, style: int, roishift: int, layers: int, r: int):
    """Tier 1 of one resolution's bands of one component: per band its
    orientation, code-block grid and blocks, each (bit planes, passes,
    bytes, [(segment bytes, passes)], layer)."""
    lib = _lib()
    out = []
    for b, (orient, bx, by, bw, bh) in enumerate(bands):
        if bw <= 0 or bh <= 0:
            continue
        cw, ch = -(-bw // cblk), -(-bh // cblk)
        coded = []
        for k in range(cw * ch):
            x0, y0 = bx + (k % cw) * cblk, by + (k // cw) * cblk
            w, h = min(cblk, bx + bw - x0), min(cblk, by + bh - y0)
            block = np.ascontiguousarray(plane[y0:y0 + h, x0:x0 + w])
            data = np.empty(w * h * 16 + 1024, np.uint8)
            info = np.zeros(3, np.int64)
            segs = np.zeros((128, 2), np.int64)
            n = lib.j2k_t1_encode(block.ctypes.data, w, w, h, orient, style, roishift, data.ctypes.data, data.size,
                                  info.ctypes.data, segs.ctypes.data, len(segs))
            if n < 0:
                raise RuntimeError("jpeg2000_encode: a code-block outgrew its buffer")
            coded.append((int(info[0]), int(info[1]), data[:n].tobytes(), [tuple(v) for v in segs[:info[2]].tolist()],
                          (k + b + r) % layers))
        out.append((orient, cw, ch, coded))
    return out


class _Resolution:
    """One resolution of one component, coded: its packets' headers and
    bodies, layer by layer (the tag trees keep their state between them)."""

    def __init__(self, coded, guard: int, roishift: int):
        self.bands = []
        for orient, cw, ch, blocks in coded:
            # Reversible: the band's Mb (E-2) is its exponent + guard bits - 1,
            # and a code-block of k bit planes has Mb - k zero bit planes
            # (Mb - k + the ROI shift: openjpeg starts at the shift + its
            # bit planes).
            expn = 8 + (0 if orient == 0 else 2 if orient == 3 else 1)
            incl = _TagTree(cw, ch, [layer if passes else 999 for _, passes, _, _, layer in blocks])
            imsb = _TagTree(cw, ch, [expn + guard - 1 - k + roishift for k, _, _, _, _ in blocks])
            self.bands.append((blocks, incl, imsb))

    def packet(self, layer: int) -> Tuple[bytes, bytes]:
        """(header, body) of the packet of ``layer``."""
        bits, body = _Bits(), []
        if not any(passes and lay == layer for blocks, _, _ in self.bands for _, passes, _, _, lay in blocks):
            bits.put(0, 1)  # an empty packet
            return bits.flush(), b""
        bits.put(1, 1)
        for blocks, incl, imsb in self.bands:
            for i, (k, passes, data, segs, lay) in enumerate(blocks):
                if passes and lay < layer:
                    bits.put(0, 1)  # included before: no new passes
                    continue
                incl.encode(bits, i, layer + 1)
                if not passes or lay != layer:
                    continue
                imsb.encode(bits, i, 999)
                _num_passes(bits, passes)
                # Lblock: each segment's length in 3 + increment + floor(log2
                # of its passes) bits.
                increment = max(max(max(n, 1).bit_length() - 3 - (np_.bit_length() - 1), 0) for n, np_ in segs)
                bits.put((1 << (increment + 1)) - 2, increment + 1)  # increment 1s, then a 0
                for n, np_ in segs:
                    bits.put(n, 3 + increment + np_.bit_length() - 1)
                body.append(data)
        return bits.flush(), b"".join(body)


def _progression(prg: int, r0: int, r1: int, c0: int, c1: int, l1: int, numres):
    """(layer, resolution, component) in a progression order over ranges,
    for one precinct a resolution (pi.c's position loops then visit each
    once, at the tile's origin)."""
    if prg == 0:
        return [(l, r, c) for l in range(l1) for r in range(r0, r1) for c in range(c0, c1) if r < numres[c]]
    if prg == 1:
        return [(l, r, c) for r in range(r0, r1) for l in range(l1) for c in range(c0, c1) if r < numres[c]]
    if prg == 2:
        return [(l, r, c) for r in range(r0, r1) for c in range(c0, c1) if r < numres[c] for l in range(l1)]
    return [(l, r, c) for c in range(c0, c1) for r in range(r0, min(r1, numres[c])) for l in range(l1)]


# The progression order changes of Pillow's cinema4k-24 writer (openjpeg's
# cinema 4K profile), in its tile-part header: CPRL over the resolutions but
# the last, then the last (REpoc and CEpoc past the end stop at it).
CINEMA4K_POC = [[(0, 0, 1, 5, 255, 4), (5, 0, 1, 33, 255, 4)]]


def _steps(levels: int, guard: int) -> bytes:
    """Sqcd/Sqcc and the reversible exponents: 8 bits plus each band's gain."""
    return bytes([guard << 5]) + bytes([(8 + g) << 3 for g in [0] + [1, 1, 2] * levels])


def _split(data: bytes, size: int) -> List[bytes]:
    return [data[i:i + size] for i in range(0, len(data), size)] or [b""]


def _ppm_segments(parts: List[bytes], size: int) -> List[bytes]:
    """Each tile-part's packet headers as Nppm then Ippm, split over PPM
    segments of at most ``size`` bytes of data, an Nppm never cut (openjpeg
    reads it whole)."""
    segments, cur = [], b""
    for headers in parts:
        if len(cur) + 4 > size:
            segments.append(cur)
            cur = b""
        cur += struct.pack(">I", len(headers))
        rest = headers
        while rest:
            take = size - len(cur)
            if take <= 0:
                segments.append(cur)
                cur, take = b"", size
            cur, rest = cur + rest[:take], rest[take:]
    return segments + [cur]


def encode_j2k(img: np.ndarray, mct: bool = False, sop: bool = False, eph: bool = False, tile_parts: int = 1,
               tlm: bool = False, coc: bool = False, qcc: bool = False, style: int = 0, layers: int = 1,
               progression: int = 0, poc: Sequence[Sequence[Tuple[int, int, int, int, int, int]]] = (),
               poc_in: str = "tile", roi: Sequence[int] = (), subsampling: Optional[Sequence[Tuple[int, int]]] = None,
               ycc: bool = False, packed: Optional[str] = None, packed_size: int = 64) -> bytes:
    """A lossless codestream of uint8 [H,W] or [H,W,C] (C 1-4); ``mct``
    (three or more channels) codes the first three through the RCT; ``coc``
    gives the last channel a COC (one decomposition level fewer, 32x32
    code-blocks), ``qcc`` a QCC (3 guard bits).

    The rest is JPEG 2000 that Pillow's writer does not make: ``style``, the
    code-block style bits (0x01 bypass, 0x02 context reset, 0x04
    termination at each pass, 0x08 vertically causal contexts, 0x10
    predictable termination, 0x20 segmentation symbols); ``layers``
    quality layers, each code-block whole in one of them; ``progression``
    (0-4, LRCP to CPRL) and ``poc``, POC marker segments of progression
    changes (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc), in the main header
    or the first tile-part's (``poc_in``); ``roi``, components coded with
    an RGN max-shift of the middle of each band; ``subsampling``, each
    component's (XRsiz, YRsiz), its samples the means of each block
    (rounded down); ``ycc``, the three first channels coded as JFIF's
    YCbCr (for a JP2 that says sYCC); ``packed``, the packet headers in PPM
    ("ppm") or PPT ("ppt") marker segments of at most ``packed_size``
    bytes of data each. With ``ycc`` or ``subsampling`` a frame is not
    its source."""
    img = np.asarray(img, np.uint8)
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    sub = list(subsampling or [(1, 1)] * nc)
    planes = _component_samples(img, ycc, sub)
    top = 5
    while top and min(min(p.shape) for p in planes) < (1 << top):  # openjpeg's writer wants 2^levels samples
        top -= 1
    levels, cblk, guard = [top] * nc, [64] * nc, [2] * nc
    if coc:
        levels[-1], cblk[-1] = max(top - 1, 0), 32
    if qcc:
        guard[-1] = 3
    planes = [p.astype(np.int32) - 128 for p in planes]
    if mct:
        r, g, b = planes[:3]
        planes[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    lib = _lib()
    for p, lv in zip(planes, levels):
        lib.j2k_fdwt53(p.ctypes.data, p.shape[1], p.shape[0], lv)
    bands = [_bands(p.shape[1], p.shape[0], lv) for p, lv in zip(planes, levels)]
    shifts = [0] * nc
    for c in roi:
        mask = _roi(bands[c])
        shifts[c] = _max_shift(planes[c], mask)
        planes[c] = np.where(mask, planes[c] << shifts[c], planes[c]).astype(np.int32)
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + b"".join(bytes([7, dx, dy]) for dx, dy in sub)
    scod = (2 if sop else 0) | (4 if eph else 0)
    cod = struct.pack(">BBHB", scod, progression, layers, int(mct)) + bytes([top, 4, 4, style, 1])
    main = b"\xff\x4f" + _segment(0xFF51, siz) + _segment(0xFF52, cod) + _segment(0xFF5C, _steps(top, 2))
    if coc:
        main += _segment(0xFF53, bytes([nc - 1, 0, levels[-1], 3, 3, style, 1]))
    if qcc:
        main += _segment(0xFF5D, bytes([nc - 1]) + _steps(levels[-1], guard[-1]))
    for c in roi:
        main += _segment(0xFF5E, bytes([c, 0, shifts[c]]))
    poc_segments = [_segment(0xFF5F, b"".join(bytes([r0, c0]) + struct.pack(">H", l1) + bytes([r1, c1, prg])
                                              for r0, c0, l1, r1, c1, prg in changes)) for changes in poc]
    if poc_in == "main":
        main += b"".join(poc_segments)
    # The packets in the progression (each once, as pi.c visits them).
    coded = {(r, c): _Resolution(_coded_bands(planes[c], bands[c][r], cblk[c], style, shifts[c], layers, r),
                                 guard[c], shifts[c])
             for c in range(nc) for r in range(levels[c] + 1)}
    numres = [lv + 1 for lv in levels]
    changes = [ch for seg in poc for ch in seg] or [(0, 0, layers, top + 1, nc, progression)]
    order, seen = [], set()
    for r0, c0, l1, r1, c1, prg in changes:
        for key in _progression(prg, r0, r1, c0, min(c1, nc), min(l1, layers), numres):
            if key not in seen:
                seen.add(key)
                order.append(key)
    if len(order) != sum(numres) * layers:
        raise ValueError("jpeg2000_encode: the progression changes leave packets out")
    packets = []
    for index, (l, r, c) in enumerate(order):
        head, body = coded[(r, c)].packet(l)
        head += b"\xff\x92" if eph else b""
        marker = _segment(0xFF91, struct.pack(">H", index & 0xFFFF)) if sop else b""
        packets.append((head, marker, body))
    # Tile-parts: whole packets each, as even a share as the packets allow.
    cuts = [round(i * len(packets) / tile_parts) for i in range(tile_parts + 1)]
    heads = [b"".join(hd for hd, _, _ in packets[a:b]) for a, b in zip(cuts, cuts[1:])]
    bodies = [b"".join(mk + bd if packed else mk + hd + bd for hd, mk, bd in packets[a:b])
              for a, b in zip(cuts, cuts[1:])]
    if packed == "ppm":
        main += b"".join(_segment(0xFF60, bytes([z]) + seg) for z, seg in enumerate(_ppm_segments(heads,
                                                                                                 packed_size)))
    elif packed not in (None, "ppt"):
        raise ValueError(f"packed {packed!r}: ppm, ppt or None")
    parts, zppt = [], 0
    for i, body in enumerate(bodies):
        header = b"".join(poc_segments) if poc_in == "tile" and i == 0 else b""
        if packed == "ppt":
            for seg in _split(heads[i], packed_size):
                header += _segment(0xFF61, bytes([zppt]) + seg)
                zppt += 1
        parts.append((header, body))
    tiles = b"".join(_segment(0xFF90, struct.pack(">HIBB", 0, 12 + len(hd) + 2 + len(bd), i, tile_parts)) + hd
                     + b"\xff\x93" + bd for i, (hd, bd) in enumerate(parts))
    if tlm:
        main += _segment(0xFF55, bytes([0, 0x50]) + b"".join(struct.pack(">BI", 0, 14 + len(hd) + len(bd))
                                                             for hd, bd in parts))
    return main + tiles + b"\xff\xd9"


def _component_samples(img: np.ndarray, ycc: bool, sub) -> List[np.ndarray]:
    """Each component's samples (uint8): the channels, or JFIF's YCbCr of
    the first three, each the means of its (XRsiz, YRsiz) blocks."""
    chans = [img[..., c] for c in range(img.shape[-1])]
    if ycc:
        r, g, b = (v.astype(np.float64) for v in chans[:3])
        chans[:3] = [np.clip(np.round(v), 0, 255).astype(np.uint8) for v in (
            0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b)]
    out = []
    for ch, (dx, dy) in zip(chans, sub):
        h, w = ch.shape
        hh, ww = -(-h // dy), -(-w // dx)
        pad = np.pad(ch.astype(np.int64), ((0, hh * dy - h), (0, ww * dx - w)), mode="edge")
        out.append((pad.reshape(hh, dy, ww, dx).sum((1, 3)) // (dx * dy)).astype(np.uint8))
    return out


def jp2(codestream: bytes, channels: int, ycc: bool = False) -> bytes:
    """A JP2 file around a codestream of 8-bit unsigned channels: the
    signature, ftyp, jp2h (ihdr, colr: sRGB for three or four channels, or
    sYCC with ``ycc``, greyscale for one or two) and jp2c boxes."""
    w, h = struct.unpack_from(">II", codestream, 8)  # Xsiz, Ysiz (the image origin is 0)

    def box(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body) + 8) + kind + body

    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, channels, 7, 7, 0, 0))
    colr = box(b"colr", struct.pack(">BBBI", 1, 0, 0, 18 if ycc else 16 if channels >= 3 else 17))
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
    return jp2(cs, 1 if np.ndim(img) == 2 else np.shape(img)[-1], options.get("ycc", False))
