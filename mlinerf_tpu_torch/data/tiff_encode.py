"""Fixture encoders for the TIFF codings that Pillow reads through libtiff's
other codecs, behind ``fixtures.encode_tiff``: JPEG (compression 7) with
shared JPEGTables, RGB, grey or YCbCr with subsampled chroma; YCbCr with
subsampling under any byte codec; Zstandard (50000; compressed blocks with
Huffman-coded literals and predefined-table sequences, raw and RLE blocks,
a content size, a checksum or a skippable frame on request); LZMA (34925,
Python's ``lzma``); CCITT RLE (2), Group 3 1D and 2D (3) and Group 4 (4);
ThunderScan (32809). (Pillow writes CCITT RLEW, 32771, itself.) Also the TIFF container itself
(:func:`tiff_file`). They write the stand-ins' frames and the tests' files;
what Pillow reads of each is the truth the port is held to.
"""

from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Compression names -> TIFF compression codes, the codings of this module.
CODINGS = {"jpeg": 7, "zstd": 50000, "lzma": 34925, "ccitt_rle": 2, "group3": 3, "group4": 4, "thunderscan": 32809}


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------

_TYPE_CODES = {3: "H", 4: "L", 5: "L", 16: "Q"}  # 5 (RATIONAL): numerator, denominator pairs


def tiff_file(chunks: Sequence[bytes], fields: Dict[int, Tuple[int, list]], byteorder: str = "<",
              bigtiff: bool = False, tile: Optional[Tuple[int, int]] = None,
              blobs: Optional[Dict[str, bytes]] = None) -> bytes:
    """A TIFF of one directory: ``blobs`` ({name: bytes}), then ``chunks``
    (strips, or tiles where ``tile`` is given), each at an even offset after
    the header, then the directory of ``fields`` ({tag: (type, values)}:
    SHORT 3, LONG 4, RATIONAL 5 as flattened numerator/denominator pairs,
    UNDEFINED 7 as one bytes value, LONG8 16; a blob's name among the values
    stands for its offset) with the chunks' offsets and byte counts
    added."""
    pointer = "Q" if bigtiff else "L"
    head = (b"II" if byteorder == "<" else b"MM") + (struct.pack(byteorder + "HHH", 43, 8, 0) if bigtiff
                                                     else struct.pack(byteorder + "H", 42))
    pos = len(head) + struct.calcsize(byteorder + pointer)
    at = {}
    for name, blob in (blobs or {}).items():
        at[name] = pos
        pos += len(blob) + len(blob) % 2
    fields = {tag: (typ, [at.get(v, v) if isinstance(v, str) else v for v in values])
              for tag, (typ, values) in fields.items()}
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c) + len(c) % 2
    fields = dict(fields)
    if tile:
        fields.update({324: (16 if bigtiff else 4, offsets), 325: (4, [len(c) for c in chunks])})
    else:
        fields.update({273: (16 if bigtiff else 4, offsets), 279: (4, [len(c) for c in chunks])})
    entry, count_fmt, inline = ("HHQ", "Q", 8) if bigtiff else ("HHL", "H", 4)
    extra, ifd = b"", b""
    ifd_at = pos
    data_at = ifd_at + struct.calcsize(byteorder + count_fmt) + len(fields) * (12 if not bigtiff else 20) \
        + struct.calcsize(byteorder + pointer)
    for tag in sorted(fields):
        typ, values = fields[tag]
        if typ == 7:
            body, count = bytes(values[0]), len(values[0])
        else:
            body = struct.pack(byteorder + _TYPE_CODES[typ] * len(values), *values)
            count = len(values) // 2 if typ == 5 else len(values)
        if len(body) <= inline:
            value = body.ljust(inline, b"\0")
        else:
            value = struct.pack(byteorder + pointer, data_at + len(extra))
            extra += body + b"\0" * (len(body) % 2)
        ifd += struct.pack(byteorder + entry, tag, typ, count) + value
    ifd = struct.pack(byteorder + count_fmt, len(fields)) + ifd + struct.pack(byteorder + pointer, 0)
    body = b"".join(c + b"\0" * (len(c) % 2) for c in [*(blobs or {}).values(), *chunks])
    return head + struct.pack(byteorder + pointer, ifd_at) + body + ifd + extra


# ---------------------------------------------------------------------------
# YCbCr
# ---------------------------------------------------------------------------


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] RGB -> YCbCr (T.871's full-range coefficients, rounded)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    ycc = np.stack([0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                    128 + 0.5 * r - 0.418688 * g - 0.081312 * b], -1)
    return np.clip(np.rint(ycc), 0, 255).astype(np.uint8)


def ycbcr_blocks(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """YCbCr samples [R, W, 3] packed as TIFF's subsampled data: per block of
    hs x vs pixels (edges replicated to whole blocks) its luma row by row,
    then the block's mean Cb and Cr."""
    r, w, _ = ycc.shape
    rb, wb = -(-r // vs), -(-w // hs)
    full = np.pad(ycc, ((0, rb * vs - r), (0, wb * hs - w), (0, 0)), mode="edge").astype(np.int64)
    blocks = full.reshape(rb, vs, wb, hs, 3).transpose(0, 2, 1, 3, 4)  # [rb, wb, vs, hs, 3]
    luma = blocks[..., 0].reshape(rb, wb, vs * hs)
    chroma = (blocks[..., 1:].sum((2, 3)) + (vs * hs) // 2) // (vs * hs)
    return np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# JPEG (compression 7)
# ---------------------------------------------------------------------------


def jpeg_tables(quality: int, components: int) -> bytes:
    """The JPEGTables field: SOI, the quantisation tables at ``quality`` and
    the Annex K Huffman tables the strips use (luma's only for one
    component), EOI."""
    from mlinerf_tpu_torch.data import fixtures as fx

    _, _, _, tables, qtables, _ = fx._quantised(np.zeros((8, 8, components), np.uint8), quality, "4:4:4", False,
                                                "jpeg_tables", convert=False)
    out = [b"\xff\xd8"]
    for t in sorted(set(tables)):
        out.append(fx._segment(0xDB, bytes([t]) + bytes(qtables[t].astype(np.uint8)[fx._ZIGZAG].tolist())))
    for (cls, ident), (counts, symbols) in fx._HUFFMAN_TABLES.items():
        if ident in tables:
            out.append(fx._segment(0xC4, bytes([(cls << 4) | ident] + counts) + symbols))
    return b"".join(out) + b"\xff\xd9"


def jpeg_chunk(samples: np.ndarray, quality: int, ycbcr: Optional[Tuple[int, int]], tables: bool = True) -> bytes:
    """A strip or tile of a JPEG-compressed TIFF: an abbreviated baseline
    stream (SOI, frame, scan, EOI; with ``tables`` False its DQT and DHT
    inline too) of uint8 samples [R, W, C]: coded as they are (photometric
    RGB or MinIsBlack), or with ``ycbcr`` = (h, v) converted to YCbCr with
    the luma sampled h x v times the chroma (photometric YCbCr)."""
    from mlinerf_tpu_torch.data import fixtures as fx

    subsampling = {v: k for k, v in fx.JPEG_SUBSAMPLING.items()}[ycbcr] if ycbcr else "4:4:4"
    h, w, factors, tabs, _, coefs = fx._quantised(samples, quality, subsampling, False, "jpeg_chunk",
                                                         convert=ycbcr is not None)
    head = b"\xff\xd8" if tables else jpeg_tables(quality, len(factors))[:-2]
    frame = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(factors)])
    frame += b"".join(bytes([ci + 1, (fh << 4) | fv, tabs[ci]]) for ci, (fh, fv) in enumerate(factors))
    head += fx._segment(0xC0, frame)
    scan = bytes([len(factors)]) + b"".join(bytes([ci + 1, (t << 4) | t]) for ci, t in enumerate(tabs))
    scan += bytes([0, 63, 0])
    return head + fx._segment(0xDA, scan) + fx._baseline_entropy(factors, tabs, coefs) + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Old-style JPEG (compression 6)
# ---------------------------------------------------------------------------

OJPEG_FORMS = ("tables", "interchange")


def ojpeg_encode(img: np.ndarray, form: str = "tables", ycbcr_subsampling: Tuple[int, int] = (2, 2),
                 rows_per_strip: Optional[int] = None, quality: int = 75, byteorder: str = "<",
                 fields: Optional[Dict[int, Optional[Tuple[int, list]]]] = None) -> bytes:
    """An old-style JPEG TIFF (compression 6, as TIFF 6.0's section 22 and
    libtiff's tif_ojpeg.c read it) of uint8 RGB [H,W,3] (YCbCr, the luma
    sampled h x v times the chroma) or grey [H,W,1]: one baseline frame
    whose entropy-coded data is cut into strips of whole MCU rows, each
    strip one restart interval (libtiff puts the RST markers between strips
    back). ``form`` "tables": the tables in JPEGQTables, JPEGDCTables and
    JPEGACTables (the chroma components sharing one offset), JPEGProc 1 and
    JPEGRestartInterval, the strips bare entropy-coded data; "interchange":
    JPEGInterchangeFormat and its length cover the stream's header (SOI,
    DQT, DHT, DRI, SOF0, SOS), the strips the data after it. ``fields``
    adds, replaces or (None) removes tags."""
    from mlinerf_tpu_torch.data import fixtures as fx

    if form not in OJPEG_FORMS:
        raise ValueError(f"form {form!r}: one of {OJPEG_FORMS}")
    img = np.asarray(img, np.uint8)
    img = img[..., None] if img.ndim == 2 else img
    h, w, spp = img.shape
    hs, vs = ycbcr_subsampling if spp == 3 else (1, 1)
    subsampling = {v: k for k, v in fx.JPEG_SUBSAMPLING.items()}[(hs, vs)]
    _, _, factors, tabs, qtables, coefs = fx._quantised(img, quality, subsampling, False, "ojpeg_encode",
                                                        convert=spp == 3)
    mcu_rows = -(-h // (8 * vs))
    mcux = -(-w // (8 * hs))
    rps = rows_per_strip or 8 * vs * max(1, -(-mcu_rows // 3))
    if rps % (8 * vs):
        raise ValueError(f"rows_per_strip {rps}: a whole number of MCU rows ({8 * vs})")
    per_strip = rps // (8 * vs)
    strips = []
    for r0 in range(0, mcu_rows, per_strip):
        r1 = min(r0 + per_strip, mcu_rows)
        strips.append(fx._baseline_entropy(factors, tabs, [c[r0 * fv:r1 * fv] for c, (_, fv) in zip(coefs, factors)]))
    restart = per_strip * mcux if len(strips) > 1 else 0
    huffman = {(cls, ident): bytes(counts) + symbols for (cls, ident), (counts, symbols) in fx._HUFFMAN_TABLES.items()}
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]), 262: (3, [6 if spp == 3 else 1]),
            277: (3, [spp]), 278: (4, [rps])}
    if spp == 3:
        tags[530] = (3, [hs, vs])
    blobs = {}
    if form == "tables":
        for t in sorted(set(tabs)):
            blobs[f"q{t}"] = bytes(qtables[t].astype(np.uint8)[fx._ZIGZAG].tolist())
            blobs[f"dc{t}"] = huffman[(0, t)]
            blobs[f"ac{t}"] = huffman[(1, t)]
        tags.update({512: (3, [1]), 519: (4, [f"q{t}" for t in tabs]), 520: (4, [f"dc{t}" for t in tabs]),
                     521: (4, [f"ac{t}" for t in tabs])})
        if restart:
            tags[515] = (3, [restart])
    else:
        head = fx._jpeg_head(0xC0, h, w, factors, tabs, qtables, b"")
        head += b"".join(fx._segment(0xC4, bytes([(cls << 4) | ident]) + huffman[(cls, ident)])
                         for (cls, ident) in fx._HUFFMAN_TABLES if ident in tabs)
        if restart:
            head += fx._segment(0xDD, restart.to_bytes(2, "big"))
        scan = bytes([spp]) + b"".join(bytes([ci + 1, (t << 4) | t]) for ci, t in enumerate(tabs)) + bytes([0, 63, 0])
        blobs["jif"] = head + fx._segment(0xDA, scan)
        tags.update({513: (4, ["jif"]), 514: (4, [len(blobs["jif"])])})
    tags.update(fields or {})
    return tiff_file(strips, {t: v for t, v in tags.items() if v is not None}, byteorder, blobs=blobs)


# ---------------------------------------------------------------------------
# Backward bitstreams (Zstandard's Huffman, FSE and sequence streams)
# ---------------------------------------------------------------------------


def _backward(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """A bitstream a Zstandard decoder reads from its end: the fields
    (``lengths`` bits of each of ``values``, in the order the decoder reads
    them, each most significant bit first) after the end mark, the last
    byte's highest set bit."""
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    pad = (-(total + 1)) % 8
    bits = np.zeros(pad + 1 + total, np.uint8)
    bits[pad] = 1
    if total:
        width = int(lengths.max())
        shifts = np.arange(width - 1, -1, -1)
        mat = (values[:, None] >> shifts[None, :]) & 1  # [n, width], each value right-aligned
        keep = shifts[None, :] < lengths[:, None]
        bits[pad + 1:] = mat[keep].astype(np.uint8)
    return np.packbits(bits)[::-1].tobytes()


class _Fse:
    """An FSE table built as a Zstandard decoder builds it, with the
    encoder's view: enc[s][X] = the state that decodes symbol s and moves to
    state X, and the bits that move it there."""

    def __init__(self, norm: Sequence[int], log: int):
        size = 1 << log
        self.log = log
        sym = np.zeros(size, np.int64)
        nxt = list(norm)
        high = size - 1
        for s, n in enumerate(norm):
            if n == -1:
                sym[high] = s
                high -= 1
                nxt[s] = 1
        step, pos = (size >> 1) + (size >> 3) + 3, 0
        for s, n in enumerate(norm):
            for _ in range(max(n, 0)):
                sym[pos] = s
                pos = (pos + step) & (size - 1)
                while pos > high:
                    pos = (pos + step) & (size - 1)
        self.sym = sym
        self.nbits = np.zeros(size, np.int64)
        self.base = np.zeros(size, np.int64)
        self.enc = {}
        for u in range(size):
            s = int(sym[u])
            ns = nxt[s]
            nxt[s] += 1
            nb = log - (ns.bit_length() - 1)
            self.nbits[u], self.base[u] = nb, (ns << nb) - size
            self.enc.setdefault(s, np.zeros(size, np.int64))[self.base[u]:self.base[u] + (1 << nb)] = u

    def states(self, symbols: Sequence[int], last_bits: bool = False):
        """Decoder states for ``symbols`` in order, each after the first
        reached from the one before, and the bits of each move: [(state,
        bits, nbits)]. The last state is any that decodes its symbol (one
        that reads at least one bit to move on, with ``last_bits``)."""
        s_last = int(symbols[-1])
        cands = np.flatnonzero(self.sym == s_last)
        if last_bits:
            cands = cands[self.nbits[cands] > 0]
            if not len(cands):
                raise ValueError("no state of the last symbol reads a bit")
        state = int(cands[0])
        out = [(state, 0, 0)]
        for s in symbols[-2::-1]:
            u = int(self.enc[int(s)][state])
            out.append((u, state - int(self.base[u]), int(self.nbits[u])))
            state = u
        return out[::-1]


def _normalize(counts: np.ndarray, log: int) -> List[int]:
    """Counts scaled to sum to 2^log, every present symbol at least 1."""
    size, total = 1 << log, int(counts.sum())
    norm = np.where(counts > 0, np.maximum(1, (counts * size) // total), 0).astype(np.int64)
    while norm.sum() != size:
        i = int(np.argmax(norm))
        norm[i] += size - norm.sum() if norm.sum() < size else -min(norm[i] - 1, norm.sum() - size)
    return norm.tolist()


def _write_distribution(norm: Sequence[int], log: int) -> bytes:
    """FSE_writeNCount: the table description a Zstandard decoder reads."""
    bits: List[Tuple[int, int]] = [(log - 5, 4)]
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    last = max(i for i, n in enumerate(norm) if n)
    s = 0
    while s <= last and remaining > 1:
        v = norm[s] + 1
        mx = 2 * threshold - 1 - remaining
        if v < mx:
            bits.append((v, nbits - 1))
        else:
            bits.append((v + mx if v >= threshold else v, nbits))
        remaining -= abs(norm[s])
        if remaining < threshold and remaining > 1:
            nbits = remaining.bit_length()
            threshold = 1 << (nbits - 1)
        s += 1
        if norm[s - 1] == 0 and remaining > 1:
            z = 0
            while s + z <= last and norm[s + z] == 0:
                z += 1
            s += z
            while z >= 3:
                bits.append((3, 2))
                z -= 3
            bits.append((z, 2))
    out, acc, n = bytearray(), 0, 0
    for v, k in bits:
        acc |= v << n
        n += k
    out = acc.to_bytes((n + 7) // 8 or 1, "little")
    return bytes(out)


# ---------------------------------------------------------------------------
# Zstandard (compression 50000)
# ---------------------------------------------------------------------------

_LL_BASE = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256,
            512, 1024, 2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
_TABLES = {}


def _predefined():
    if not _TABLES:
        _TABLES.update(ll=_Fse(_LL_DEFAULT, 6), of=_Fse(_OF_DEFAULT, 5), ml=_Fse(_ML_DEFAULT, 6))
    return _TABLES


def _code(value: int, base: Sequence[int], bits: Sequence[int]) -> Tuple[int, int, int]:
    """(code, extra bits value, extra bit count) of a literal or match length."""
    c = int(np.searchsorted(base, value, side="right")) - 1
    return c, value - base[c], bits[c]


def _huffman_lengths(counts: np.ndarray, max_bits: int = 11) -> np.ndarray:
    """Code lengths of a Huffman code of ``counts`` limited to ``max_bits``
    (by scaling the counts down until it fits), 0 for absent symbols; at
    least two symbols."""
    import heapq

    counts = counts.astype(np.int64).copy()
    while True:
        live = [(int(c), i) for i, c in enumerate(counts) if c > 0]
        heap = [(c, i, (i,)) for c, i in live]
        heapq.heapify(heap)
        depth = np.zeros(len(counts), np.int64)
        while len(heap) > 1:
            c1, i1, s1 = heapq.heappop(heap)
            c2, i2, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                depth[s] += 1
            heapq.heappush(heap, (c1 + c2, min(i1, i2), s1 + s2))
        if depth.max() <= max_bits:
            return depth
        counts = np.where(counts > 0, (counts + 1) // 2, 0)


def _huffman_literals(lit: np.ndarray, streams: int, weights: str, state: Optional[dict] = None) -> Optional[bytes]:
    """A Huffman-compressed literals section (header, tree description and
    ``streams`` streams), or None where the literals do not suit it. With
    ``weights`` "treeless", the table of the last one (kept in ``state``)
    where it codes every literal: a treeless section."""
    counts = np.bincount(lit, minlength=256)
    if (counts > 0).sum() < 2 or (streams == 4 and len(lit) < 6) or len(lit) > 0x3FFFF:
        return None
    treeless = weights == "treeless"
    if treeless:
        if not state or "lengths" not in state or (state["lengths"][counts > 0] == 0).any():
            return None
        lengths = state["lengths"]
    else:
        lengths = _huffman_lengths(counts)
    log = int(lengths.max())
    top = int(np.flatnonzero(lengths)[-1])
    w = np.where(lengths > 0, log + 1 - lengths, 0)
    if treeless:
        tree = b""
    elif weights == "direct":
        if top > 128:
            return None
        wl = w[:top].tolist() + ([0] if top % 2 else [])
        tree = bytes([127 + top]) + bytes(wl[i] << 4 | wl[i + 1] for i in range(0, len(wl), 2))
    else:
        tree = _fse_weights(w[:top])
        if tree is None:
            return None
    # Canonical codes: by weight ascending, symbol ascending, from 0.
    code = np.zeros(256, np.int64)
    pos = 0
    for wt in range(1, log + 1):
        for s in np.flatnonzero(w == wt):
            code[s] = pos >> (wt - 1)
            pos += 1 << (wt - 1)
    n = len(lit)
    if streams == 1:
        parts = [lit]
    else:
        seg = (n + 3) // 4
        parts = [lit[i * seg:(i + 1) * seg] for i in range(3)] + [lit[3 * seg:]]
    coded = [_backward(code[p], lengths[p]) for p in parts]
    if streams == 4:
        if any(len(c) > 0xFFFF for c in coded[:3]):
            return None
        body = tree + struct.pack("<HHH", *(len(c) for c in coded[:3])) + b"".join(coded)
    else:
        body = tree + coded[0]
    csize, kind = len(body), 3 if treeless else 2
    if streams == 1 and n < 1024 and csize < 1024:
        head = (kind | (0 << 2) | (n << 4) | (csize << 14)).to_bytes(3, "little")
    elif n < 1024 and csize < 1024:
        head = (kind | (1 << 2) | (n << 4) | (csize << 14)).to_bytes(3, "little")
    elif streams == 1:
        return None
    elif n < 16384 and csize < 16384:
        head = (kind | (2 << 2) | (n << 4) | (csize << 18)).to_bytes(4, "little")
    else:
        head = (kind | (3 << 2) | (n << 4) | (csize << 22)).to_bytes(5, "little")
    if state is not None and not treeless:
        state["lengths"] = lengths
    return head + body


def _fse_weights(w: np.ndarray) -> Optional[bytes]:
    """Huffman weights FSE-compressed with two interleaved states (at
    least two weights), or None where no table of accuracy 5 or 6 codes
    them."""
    counts = np.bincount(w, minlength=13)
    for log in (6, 5):
        if (counts > 0).sum() < 2 or len(w) < 2:
            return None
        norm = _normalize(counts, log)
        table = _Fse(norm, log)
        lanes = [w[0::2].tolist(), w[1::2].tolist()]
        n = len(w)
        # The lane that decodes the second to last weight must read a bit
        # past the stream's start to end it.
        ends = (n - 2) % 2
        try:
            st = [table.states(lanes[k], last_bits=(k == ends)) for k in range(2)]
        except ValueError:
            continue
        fields = [(st[0][0][0], log), (st[1][0][0], log)]
        for i in range(n - 2):  # the moves after weights 0 .. n-3
            lane, j = i % 2, i // 2
            fields.append(st[lane][j][1:])
        stream = _backward(*zip(*fields))
        desc = _write_distribution(norm, log)
        if len(desc) + len(stream) < 128:
            return bytes([len(desc) + len(stream)]) + desc + stream
    return None


def _literals_section(lit: np.ndarray, mode: str, state: dict) -> bytes:
    """The literals section in ``mode``: "raw", "rle", "huffman" (4 streams
    where there are enough, FSE-compressed weights where they fit),
    "huffman1" (one stream, weights sent directly) or "treeless" (as
    "huffman", the last block's table again where it codes every
    literal)."""
    n = len(lit)
    if mode == "rle" and n and (lit == lit[0]).all():
        return _lit_header(1, n) + bytes([int(lit[0])])
    if mode == "huffman1":
        out = _huffman_literals(lit, 1, "direct", state)
        if out is not None:
            return out
    if mode in ("huffman", "treeless"):
        tries = ((4, "treeless"), (1, "treeless")) if mode == "treeless" else ()
        for streams, weights in tries + ((4, "fse"), (4, "direct"), (1, "fse"), (1, "direct")):
            out = _huffman_literals(lit, streams, weights, state)
            if out is not None and len(out) < n:
                return out
    return _lit_header(0, n) + lit.tobytes()


def _lit_header(kind: int, n: int) -> bytes:
    if n < 32:
        return bytes([kind | (n << 3)])
    if n < 4096:
        return (kind | (1 << 2) | (n << 4)).to_bytes(2, "little")
    return (kind | (3 << 2) | (n << 4)).to_bytes(3, "little")


def _matches(data: np.ndarray, offsets: Sequence[int], min_match: int = 4) -> List[Tuple[int, int, int]]:
    """Greedy (start, length, offset) matches of ``data`` at the given
    offsets, no two overlapping."""
    n = len(data)
    best_len = np.zeros(n, np.int64)
    best_off = np.zeros(n, np.int64)
    for off in offsets:
        if off >= n:
            continue
        eq = np.zeros(n, bool)
        eq[off:] = data[off:] == data[:-off]
        # Run lengths of True from each position onward.
        idx = np.arange(n)
        false_at = np.where(~eq, idx, n)
        next_false = np.minimum.accumulate(false_at[::-1])[::-1]
        run = next_false - idx
        better = run > best_len
        best_len[better], best_off[better] = run[better], off
    out, p = [], 0
    cand = np.flatnonzero(best_len >= min_match)
    for c in cand.tolist():
        if c < p:
            continue
        length = int(min(best_len[c], 131074))
        out.append((c, length, int(best_off[c])))
        p = c + length
    return out


class _Rle:
    """The one-state table of a sequence code sent in RLE mode."""

    def __init__(self, symbol: int):
        self.log, self.symbol = 0, symbol

    def states(self, symbols):
        return [(0, 0, 0)] * len(symbols)


def _compressed_block(block: np.ndarray, lit_mode: str, offsets: Sequence[int], sequences: str, state: dict) -> bytes:
    """A compressed block: literals in ``lit_mode``, sequences of the
    greedy matches at ``offsets`` coded with the predefined tables, or with
    ``sequences`` "rle" in RLE mode for each code that never changes."""
    seqs, lits, p = [], [], 0
    for start, length, off in _matches(block, offsets):
        lits.append(block[p:start])
        seqs.append((start - p, length, off))
        p = start + length
    lits.append(block[p:])
    lit = np.concatenate(lits) if lits else np.zeros(0, np.uint8)
    out = _literals_section(lit, lit_mode, state)
    n = len(seqs)
    if n == 0:
        return out + b"\x00"
    out += bytes([n]) if n < 128 else (bytes([0x80 + (n >> 8), n & 255]) if n < 0x7F00
                                       else b"\xff" + struct.pack("<H", n - 0x7F00))
    codes = []
    for ll, ml, off in seqs:
        llc, llx, llb = _code(ll, _LL_BASE, _LL_BITS)
        mlc, mlx, mlb = _code(ml, _ML_BASE, _ML_BITS)
        v = off + 3
        ofc = v.bit_length() - 1
        codes.append((llc, llx, llb, mlc, mlx, mlb, ofc, v - (1 << ofc)))
    tables, modes, descs = {}, 0, b""
    for name, col, shift in (("ll", 0, 6), ("of", 6, 4), ("ml", 3, 2)):
        symbols = {c[col] for c in codes}
        if sequences == "rle" and len(symbols) == 1:
            tables[name] = _Rle(symbols.pop())
            modes |= 1 << shift
            descs += bytes([tables[name].symbol])
        else:
            tables[name] = _predefined()[name]
    out += bytes([modes]) + descs
    sll = tables["ll"].states([c[0] for c in codes])
    sml = tables["ml"].states([c[3] for c in codes])
    sof = tables["of"].states([c[6] for c in codes])
    fields = [(sll[0][0], tables["ll"].log), (sof[0][0], tables["of"].log), (sml[0][0], tables["ml"].log)]
    for i, (llc, llx, llb, mlc, mlx, mlb, ofc, ofx) in enumerate(codes):
        fields += [(ofx, ofc), (mlx, mlb), (llx, llb)]
        if i + 1 < n:
            fields += [sll[i][1:], sml[i][1:], sof[i][1:]]
    return out + _backward(*zip(*fields))


def _xxh64(data: bytes) -> int:
    p1, p2, p3, p4, p5 = (11400714785074694791, 14029467366897019727, 1609587929392839161, 9650029242287828579,
                          2870177450012600261)
    m = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, v):
        return rotl((acc + v * p2) & m, 31) * p1 & m

    n, i = len(data), 0
    if n >= 32:
        v = [(p1 + p2) & m, p2, 0, (-p1) & m]
        while i + 32 <= n:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[i + 8 * k:i + 8 * k + 8], "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for k in range(4):
            h = ((h ^ rnd(0, v[k])) * p1 + p4) & m
    else:
        h = p5
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h ^= h >> 33
    h = h * p2 & m
    h ^= h >> 29
    h = h * p3 & m
    return h ^ (h >> 32)


def zstd_frame(data: bytes, literals: str = "huffman", offsets: Sequence[int] = (1, 2, 3, 4), block_size: int = 65536,
               content_size: bool = False, checksum: bool = False, skippable: str = "", raw_every: int = 0,
               rle_blocks: bool = True, sequences: str = "predefined") -> bytes:
    """A Zstandard frame of ``data``: blocks of ``block_size`` bytes, each
    an RLE block where it is one byte repeated (with ``rle_blocks``), else a
    compressed block (literals as :func:`_literals_section` codes them in
    ``literals``, greedy matches at ``offsets``, sequences as
    :func:`_compressed_block` codes them) or a raw block where that is no
    smaller or every ``raw_every``-th block. ``content_size`` writes the
    size (as a single segment), ``checksum`` the XXH64 checksum;
    ``skippable`` "before" or "after" adds a skippable frame there (before
    it, libzstd's stream decoder returns at the skippable frame's end and
    libtiff reads no more of the strip)."""
    arr = np.frombuffer(data, np.uint8)
    if content_size:
        n = len(data)
        fcs_code, fcs = ((0, bytes([n])) if n < 256 else (1, (n - 256).to_bytes(2, "little")) if n < 65536 + 256
                         else (2, n.to_bytes(4, "little")) if n < 2 ** 32 else (3, n.to_bytes(8, "little")))
        head = bytes([(fcs_code << 6) | (1 << 5) | (checksum << 2)]) + fcs
    else:
        head = bytes([checksum << 2, (17 - 10) << 3])  # a 128 KiB window
    blocks, state = [], {}
    starts = list(range(0, len(data), block_size)) or [0]
    for k, s in enumerate(starts):
        b = arr[s:s + block_size]
        last = int(k == len(starts) - 1)
        if rle_blocks and len(b) and (b == b[0]).all():
            blocks.append((last | (1 << 1) | (len(b) << 3)).to_bytes(3, "little") + bytes([int(b[0])]))
            continue
        body = _compressed_block(b, literals, offsets, sequences, state) if not (raw_every and k % raw_every == raw_every - 1) else None
        if body is None or len(body) >= len(b):
            blocks.append((last | (len(b) << 3)).to_bytes(3, "little") + b.tobytes())
        else:
            blocks.append((last | (2 << 1) | (len(body) << 3)).to_bytes(3, "little") + body)
    frame = struct.pack("<I", 0xFD2FB528) + head + b"".join(blocks)
    if checksum:
        frame += struct.pack("<I", _xxh64(data) & 0xFFFFFFFF)
    skip = struct.pack("<II", 0x184D2A50, 5) + b"skip!"
    return (skip if skippable == "before" else b"") + frame + (skip if skippable == "after" else b"")


# ---------------------------------------------------------------------------
# CCITT (compressions 2, 32771, 3, 4)
# ---------------------------------------------------------------------------


def _fax_codes():
    """T.4's modified Huffman codes, {run: bits} for white and for black."""
    white = dict(enumerate(
        "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
        "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
        "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
        "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
        "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
        "00110011 00110100".split()))
    white.update(zip(range(64, 1729, 64), (
        "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
        "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
        "010011000 010011001 010011010 011000 010011011").split()))
    black = dict(enumerate(
        "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
        "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
        "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
        "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
        "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
        "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
        "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 000000101011 "
        "000000101100 000001011010 000001100110 000001100111".split()))
    black.update(zip(range(64, 1729, 64), (
        "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
        "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
        "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
        "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()))
    common = dict(zip(range(1792, 2561, 64), (
        "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 000000010110 "
        "000000010111 000000011100 000000011101 000000011110 000000011111").split()))
    white.update(common)
    black.update(common)
    return white, black


_FAX = {}


def _span(run: int, black: bool) -> str:
    """A run's make-up and terminating codes (T.4 1D)."""
    if not _FAX:
        _FAX["w"], _FAX["b"] = _fax_codes()
    codes = _FAX["b" if black else "w"]
    out = []
    while run >= 2560:
        out.append(codes[2560])
        run -= 2560
    if run >= 64:
        out.append(codes[run // 64 * 64])
        run %= 64
    out.append(codes[run])
    return "".join(out)


def _changes(row: np.ndarray) -> np.ndarray:
    """Positions where the colour changes (the first pixel of each run; the
    row starts white), then the row's width."""
    d = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8)])))
    return np.concatenate([d, [len(row)]])


def _row_1d(row: np.ndarray) -> str:
    ch = _changes(row)
    out, a0, black = [], 0, False
    for c in ch.tolist():
        out.append(_span(c - a0, black))
        a0, black = c, not black
    return "".join(out)


_V = {-3: "0000011", -2: "000011", -1: "011", 0: "1", 1: "010", 2: "000010", 3: "0000010"}


def _row_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """T.4 2D (MR) coding of ``row`` against ``ref``, as libtiff's
    Fax3Encode2DRow chooses its modes."""
    w = len(row)

    def finddiff(line, start, colour):  # first position >= start whose pixel is not `colour`
        if start >= w:
            return w
        nz = np.flatnonzero(line[start:] != colour)
        return start + int(nz[0]) if len(nz) else w

    def pixel(line, i):
        return int(line[i]) if i < w else 0

    out = []
    a0 = 0
    a1 = 0 if row[0] else finddiff(row, 0, 0)
    b1 = 0 if ref[0] else finddiff(ref, 0, 0)
    while True:
        b2 = finddiff(ref, b1, pixel(ref, b1)) if b1 < w else w
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = finddiff(row, a1, pixel(row, a1)) if a1 < w else w
                out.append("001")
                if a0 + a1 == 0 or pixel(row, a0) == 0:
                    out += [_span(a1 - a0, False), _span(a2 - a1, True)]
                else:
                    out += [_span(a1 - a0, True), _span(a2 - a1, False)]
                a0 = a2
            else:
                out.append(_V[d])
                a0 = a1
        else:
            out.append("0001")
            a0 = b2
        if a0 >= w:
            break
        colour = pixel(row, a0)
        a1 = finddiff(row, a0, colour)
        b1 = finddiff(ref, a0, 1 - colour)
        b1 = finddiff(ref, b1, colour)
    return "".join(out)


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def fax_encode(rows: np.ndarray, compression: int, two_d: bool = False, k: int = 4, fill_bits: bool = False) -> bytes:
    """CCITT coding of 1-bit rows [R, W] (1 = a set bit, black): RLE (2:
    rows of 1D runs, each padded to a byte), Group 3 (3: each row after an
    EOL, 2D with ``two_d`` and every
    ``k``-th row 1D, EOLs padded to end on a byte with ``fill_bits``,
    closed by an RTC) or Group 4 (4: every row 2D, then an EOFB)."""
    rows = np.asarray(rows).astype(np.uint8) & 1
    w = rows.shape[1]
    out = []
    ref = np.zeros(w, np.uint8)
    eol = "000000000001"
    for i, row in enumerate(rows):
        if compression == 2:
            bits = _row_1d(row)
            out.append(bits + "0" * (-len(bits) % 8))
        elif compression == 3:
            pos = sum(len(b) for b in out)
            pad = ((-(pos + 12)) % 8) if fill_bits else 0
            if two_d:
                one = i % k == 0
                out.append("0" * pad + eol + ("1" + _row_1d(row) if one else "0" + _row_2d(row, ref)))
            else:
                out.append("0" * pad + eol + _row_1d(row))
        else:
            out.append(_row_2d(row, ref))
        ref = row
    if compression == 3:
        out.append((eol + ("1" if two_d else "")) * 6)
    if compression == 4:
        out.append(eol * 2)
    return _bits_to_bytes("".join(out))


# ---------------------------------------------------------------------------
# ThunderScan (compression 32809)
# ---------------------------------------------------------------------------

_D2 = {0: 0, 1: 1, -1: 3}
_D3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}


def thunder_encode(rows: np.ndarray, seed: int = 0) -> bytes:
    """ThunderScan coding of 4-bit rows [R, W]: each row from a last pixel of
    0, runs of the last pixel (from an even position, never the row's last
    pixels, where libtiff leaves them unwritten), three 2-bit or two 3-bit
    deltas, or raw values, the choice among those that fit drawn from
    ``seed``."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for row in np.asarray(rows).astype(np.int64) & 15:
        row = row.tolist()
        w, i, last = len(row), 0, 0

        def delta(p, q):
            d = (q - p) % 16
            return d - 16 if d > 8 else d

        while i < w:
            options = []
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2 and i % 2 == 0 and i + run < w:
                options.append("run")
            if i + 3 <= w:
                d = [delta(last, row[i]), delta(row[i], row[i + 1]), delta(row[i + 1], row[i + 2])]
                if all(x in _D2 for x in d):
                    options.append("d2")
            if i + 2 <= w:
                d = [delta(last, row[i]), delta(row[i], row[i + 1])]
                if all(x in _D3 for x in d):
                    options.append("d3")
            choice = options[int(rng.integers(len(options)))] if options else "raw"
            if choice == "run":
                out.append(run)
                i += run
            elif choice == "d2":
                d = [delta(last, row[i]), delta(row[i], row[i + 1]), delta(row[i + 1], row[i + 2])]
                out.append(0x40 | _D2[d[0]] << 4 | _D2[d[1]] << 2 | _D2[d[2]])
                last, i = row[i + 2], i + 3
            elif choice == "d3":
                d = [delta(last, row[i]), delta(row[i], row[i + 1])]
                out.append(0x80 | _D3[d[0]] << 3 | _D3[d[1]])
                last, i = row[i + 1], i + 2
            else:
                out.append(0xC0 | row[i])
                last, i = row[i], i + 1
    return bytes(out)


# ---------------------------------------------------------------------------
# The TIFF files
# ---------------------------------------------------------------------------


def encode(img: np.ndarray, compression: str, byteorder: str = "<", tile: Optional[Tuple[int, int]] = None,
           rows_per_strip: Optional[int] = None, photometric: Optional[int] = None, predictor: int = 1,
           extra_samples: Sequence[int] = (), bits: Optional[int] = None, orientation: Optional[int] = None,
           fill_order: int = 1, ycbcr_subsampling: Optional[Tuple[int, int]] = None, quality: int = 90,
           fields: Optional[Dict[int, Optional[Tuple[int, list]]]] = None, planar: int = 1, **codec) -> bytes:
    """A TIFF of ``img`` [H,W,S] in one of this module's codings or, with
    photometric 6 (YCbCr) and ``ycbcr_subsampling``, in any of
    ``fixtures.encode_tiff``'s byte codings with the RGB ``img`` converted
    and subsampled (``planar`` 2: each converted plane on its own, at
    1x1). ``fields`` adds, replaces or (None) removes tags ({tag: (type,
    values)}); ``codec`` goes to the coder: zstd_frame's options for
    "zstd", fax_encode's for the CCITT codings, ``seed`` for ThunderScan,
    ``tables`` False to put a JPEG's tables in each strip, ``check`` for
    LZMA (an lzma.CHECK_*)."""
    from mlinerf_tpu_torch.data import fixtures as fx

    img = np.asarray(img)
    img = img[..., None] if img.ndim == 2 else img
    h, w, spp = img.shape
    code = CODINGS.get(compression) or fx._TIFF_COMPRESSION[compression]
    bits = bits or (1 if code in (2, 3, 4) else 4 if code == 32809 else img.dtype.itemsize * 8)
    photometric = photometric if photometric is not None else (2 if spp >= 3 else 1)
    ycc = photometric == 6
    hs, vs = ycbcr_subsampling or ((2, 2) if ycc else (1, 1))
    tw, tl = tile or (w, rows_per_strip or (max(16, 8192 // max(1, w * spp)) // 16 * 16))
    dtype = img.dtype.newbyteorder(byteorder) if bits % 8 == 0 else img.dtype
    planes = [img] if planar == 1 else [rgb_to_ycbcr(img)[..., k:k + 1] if ycc else img[..., k:k + 1]
                                        for k in range(spp)]
    chunks = []
    for plane, y, x in ((p, y, x) for p in planes for y in range(0, h, tl) for x in range(0, w, tw)):
        block = plane[y:y + tl, x:x + tw]
        if tile:
            block = np.pad(block, ((0, tl - len(block)), (0, tw - block.shape[1]), (0, 0)), mode="edge")
        if code == 7:
            chunks.append(jpeg_chunk(block, quality, (hs, vs) if ycc and planar == 1 else None,
                                     codec.get("tables", True)))
            continue
        if code in (2, 3, 4):
            chunks.append(fax_encode(block[..., 0], code, **codec))
            continue
        if code == 32809:
            chunks.append(thunder_encode(block[..., 0], **codec))
            continue
        if ycc and planar == 1:
            raw = ycbcr_blocks(rgb_to_ycbcr(block), hs, vs)
        else:
            flat = block.reshape(len(block), -1)
            if predictor == 2:
                flat = fx._predict(flat, 2, block.shape[-1])
            raw = flat.astype(dtype).tobytes()
        if code == 50000:
            chunks.append(zstd_frame(raw, **codec))
        elif code == 34925:
            chunks.append(lzma.compress(raw, format=lzma.FORMAT_XZ, check=codec.get("check", lzma.CHECK_CRC64)))
        else:
            chunks.append({1: bytes, 5: fx._lzw, 8: zlib.compress, 32946: zlib.compress,
                           32773: fx._packbits}[code](raw))
    if fill_order == 2 and code != 7:  # libtiff reverses the bits of the stored bytes (JPEG's are never reversed)
        chunks = [fx._REVERSED[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [code]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags.update({322: (4, [tw]), 323: (4, [tl])})
    else:
        tags[278] = (4, [tl])
    for tag, value in ((266, fill_order if fill_order != 1 else None), (274, orientation),
                       (317, predictor if predictor != 1 else None)):
        if value is not None:
            tags[tag] = (3, [value])
    if extra_samples:
        tags[338] = (3, list(extra_samples))
    if ycc:
        tags[530] = (3, [hs, vs])
    if code == 7 and codec.get("tables", True):
        tags[347] = (7, [jpeg_tables(quality, spp)])
    if code == 3 and (codec.get("two_d") or codec.get("fill_bits")):
        tags[292] = (4, [int(bool(codec.get("two_d"))) | (4 if codec.get("fill_bits") else 0)])
    tags.update(fields or {})
    tags = {t: v for t, v in tags.items() if v is not None}
    return tiff_file(chunks, tags, byteorder, tile=tile)
