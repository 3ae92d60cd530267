"""WebP encoders for the stand-in captures and the tests: what a camera or a
web pipeline writes, and the codings Pillow cannot ask libwebp for (the
simple loop filter, 2, 4 or 8 token partitions, sharpness above 0, raw
alpha, a chosen alpha filter, frame 0 of an animation smaller than its
canvas). The card's machine has no Pillow, so the stand-ins are written
here; ``fixtures.encode_webp`` is the entry point.

- VP8 key frames (RFC 6386): the boolean encoder, 16x16 DC/TM/V/H and
  B_PRED with all ten 4x4 modes (chosen by the smallest error, or drawn
  from a seed), a fixed quantizer per segment, the default token
  probabilities (optionally some replaced through the header's updates),
  the skip flag, 1 to 8 token partitions, the simple or normal loop filter
  with its sharpness and deltas. The encoder reconstructs each macroblock
  as the decoder will, so its predictions do not drift.
- VP8L: subtract-green, predictor (each tile's mode the one with the
  smallest residual, or drawn, or given), cross-colour and
  colour-indexing transforms in any order, backward references (runs
  copied from the left or from above, through the distance map's codes and
  the plain ones), the colour cache and meta (entropy-image) prefix codes.
- ALPH: raw or VP8L-coded, under the horizontal, vertical or gradient
  filter.
- The RIFF container: simple, VP8X with ICCP/EXIF/XMP chunks, and
  ANIM/ANMF with frame 0 at an offset inside a larger canvas.

The VP8 probability and quantizer tables come from the port's decoder
library (csrc/webp_decode.cpp), which holds the spec's tables once.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# VP8L
# ---------------------------------------------------------------------------

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_TRANSFORM_TYPES = {"predictor": 0, "cross_color": 1, "subtract_green": 2, "palette": 3}


class _Bits:
    """Values of up to 24 bits appended least significant bit first."""

    def __init__(self):
        self.vals, self.lens = [], []

    def put(self, value: int, nbits: int):
        self.vals.append(np.array([value], np.int64))
        self.lens.append(np.array([nbits], np.int64))

    def put_many(self, values: np.ndarray, nbits: np.ndarray):
        self.vals.append(np.asarray(values, np.int64))
        self.lens.append(np.asarray(nbits, np.int64))

    def tobytes(self) -> bytes:
        vals = np.concatenate(self.vals) if self.vals else np.zeros(0, np.int64)
        lens = np.concatenate(self.lens) if self.lens else np.zeros(0, np.int64)
        pos = np.cumsum(lens) - lens
        bits = np.zeros(int(lens.sum()), np.uint8)
        for k in range(int(lens.max(initial=0))):
            live = lens > k
            bits[pos[live] + k] = (vals[live] >> k) & 1
        return np.packbits(bits, bitorder="little").tobytes()


def _huffman_lengths(hist: np.ndarray, limit: int) -> np.ndarray:
    """Code lengths of a Huffman code of the histogram, at most ``limit``
    bits (the counts halved until it fits); one used symbol gets 1."""
    hist = np.asarray(hist, np.int64)
    lengths = np.zeros(len(hist), np.int64)
    used = np.flatnonzero(hist)
    if len(used) == 1:
        lengths[used[0]] = 1
    if len(used) <= 1:
        return lengths
    counts = hist[used].copy()
    while True:
        heap = [(int(c), i, (int(s),)) for i, (c, s) in enumerate(zip(counts, used))]
        heapq.heapify(heap)
        depth = {int(s): 0 for s in used}
        tie = len(heap)
        while len(heap) > 1:
            c1, _, s1 = heapq.heappop(heap)
            c2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                depth[s] += 1
            heapq.heappush(heap, (c1 + c2, tie, s1 + s2))
            tie += 1
        if max(depth.values()) <= limit:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        counts = np.maximum(counts // 2, 1)


def _canonical(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(code written least significant bit first, its length) of each
    symbol of a canonical code; a one-symbol code writes no bits."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(len(lengths), np.int64)
    nbits = lengths.copy()
    used = np.flatnonzero(lengths)
    if len(used) == 1:
        nbits[:] = 0
        return codes, nbits
    code = 0
    for length in range(1, 16):
        for s in np.flatnonzero(lengths == length):
            codes[s] = int(f"{code:0{length}b}"[::-1], 2)
            code += 1
        code <<= 1
    return codes, nbits


def _length_tokens(lengths: np.ndarray):
    """(symbol, extra bits' value, their count) of code lengths."""
    tokens = []
    i, prev = 0, 8
    while i < len(lengths):
        v = int(lengths[i])
        run = 1
        while i + run < len(lengths) and lengths[i + run] == v:
            run += 1
        if v == 0 and run >= 3:
            n = min(run, 138)
            tokens.append((17, n - 3, 3) if n <= 10 else (18, n - 11, 7))
            i += n
        elif v != 0 and v == prev and run >= 3:
            n = min(run, 6)
            tokens.append((16, n - 3, 2))
            i += n
        else:
            tokens.append((v, 0, 0))
            prev = v if v else prev
            i += 1
    return tokens


def _write_code(bw: _Bits, hist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Writes a prefix code for the histogram (a simple code where it has at
    most two symbols below 256); returns the symbols' (codes, lengths)."""
    used = np.flatnonzero(hist)
    if len(used) == 0:
        hist = np.zeros(len(hist), np.int64)
        hist[0] = 1
        used = np.array([0])
    if len(used) <= 2 and used.max() < 256:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        first = int(used[0])
        bw.put(int(first > 1), 1)
        bw.put(first, 8 if first > 1 else 1)
        if len(used) == 2:
            bw.put(int(used[1]), 8)
        lengths = np.zeros(len(hist), np.int64)
        lengths[used] = 1
        return _canonical(lengths)
    lengths = _huffman_lengths(hist, 15)
    # The lengths as code-length symbols: 0-15, 16 (repeat the last
    # non-zero length 3-6 times), 17 (3-10 zeros), 18 (11-138 zeros); past
    # the last non-zero length none are written where the count of symbols
    # read (max_symbol) can say so.
    last = int(np.flatnonzero(lengths).max()) + 1
    tokens = _length_tokens(lengths[:last])
    if last == len(hist) or len(tokens) < 2:
        tokens, last = _length_tokens(lengths), len(hist)
    cl_hist = np.bincount([t[0] for t in tokens], minlength=19)
    cl_lengths = _huffman_lengths(cl_hist, 7)
    num_codes = max(4, max(k + 1 for k, s in enumerate(_CODE_LENGTH_ORDER) if cl_lengths[s]))
    bw.put(0, 1)
    bw.put(num_codes - 4, 4)
    for k in range(num_codes):
        bw.put(int(cl_lengths[_CODE_LENGTH_ORDER[k]]), 3)
    if last < len(hist):  # stop after the tokens of the lengths up to the last non-zero one
        n = len(tokens)
        nbits = 2
        while n - 2 >= (1 << nbits):
            nbits += 2
        bw.put(1, 1)
        bw.put((nbits - 2) // 2, 3)
        bw.put(n - 2, nbits)
    else:
        bw.put(0, 1)
    cl_codes, cl_bits = _canonical(cl_lengths)
    for sym, extra, extra_bits in tokens:
        bw.put(int(cl_codes[sym]), int(cl_bits[sym]))
        if extra_bits:
            bw.put(extra, extra_bits)
    return _canonical(lengths)


def _prefix(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lengths and distances (>= 1) as (prefix symbol, extra bits' value,
    their count)."""
    d = np.asarray(values, np.int64) - 1
    high = np.where(d > 0, np.floor(np.log2(np.maximum(d, 1))).astype(np.int64), 0)
    small = d < 4
    second = np.where(small, 0, (d >> np.maximum(high - 1, 0)) & 1)
    sym = np.where(small, d, 2 * high + second)
    nbits = np.where(small, 0, high - 1)
    extra = np.where(small, 0, d & ((1 << nbits) - 1))
    return sym, extra, nbits


def _cache_hits(argb: np.ndarray, cache_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hit, key) of each pixel: whether the colour cache, holding every
    earlier pixel by its hash, gives the pixel itself."""
    key = ((argb.astype(np.uint64) * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)
    order = np.lexsort((np.arange(len(argb)), key))
    prev_same_key = np.zeros(len(argb), bool)
    prev_same_key[order[1:]] = key[order[1:]] == key[order[:-1]]
    prev_pixel = np.zeros(len(argb), np.uint32)
    prev_pixel[order[1:]] = argb[order[:-1]]
    return prev_same_key & (prev_pixel == argb), key.astype(np.int64)


def _runs(mask: np.ndarray, min_len: int):
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
    keep = ends - starts >= min_len
    return starts[keep], ends[keep]


def _image_data(bw: _Bits, argb: np.ndarray, width: int, cache_bits: int, backrefs: bool,
                groups: Optional[np.ndarray], rng: np.random.Generator):
    """The prefix codes and the entropy-coded pixels of an image (ARGB
    uint32, row by row); ``groups``: each pixel's prefix-code group."""
    n = len(argb)
    covered = np.zeros(n, bool)
    seg_start, seg_len, seg_dist = [], [], []
    if backrefs:
        for dist in (1, width):
            if dist >= n:
                continue
            same = np.zeros(n, bool)
            same[dist:] = argb[dist:] == argb[:-dist]
            starts, ends = _runs(same & ~covered, 3)
            for s, e in zip(starts.tolist(), ends.tolist()):
                for c in range(s, e, 4096):
                    seg_start.append(c)
                    seg_len.append(min(4096, e - c))
                    seg_dist.append(dist)
                covered[s:e] = True
    hit, key = _cache_hits(argb, cache_bits) if cache_bits else (np.zeros(n, bool), np.zeros(n, np.int64))
    lit_pos = np.flatnonzero(~covered)
    ev_pos = np.concatenate([lit_pos, np.array(seg_start, np.int64)])
    ev_kind = np.concatenate([np.where(hit[lit_pos], 1, 0), np.full(len(seg_start), 2)])  # 0 literal, 1 cache, 2 ref
    ev_len = np.concatenate([np.ones(len(lit_pos), np.int64), np.array(seg_len, np.int64)])
    ev_dist = np.concatenate([np.zeros(len(lit_pos), np.int64), np.array(seg_dist, np.int64)])
    order = np.argsort(ev_pos, kind="stable")
    ev_pos, ev_kind, ev_len, ev_dist = ev_pos[order], ev_kind[order], ev_len[order], ev_dist[order]
    # Distances through the map's codes (1: the pixel above, 2: the one to
    # the left) or as themselves plus 120, drawn per reference.
    plain = rng.random(len(ev_pos)) < 0.5
    dist_code = np.where(plain, ev_dist + 120, np.where(ev_dist == 1, 2, 1))
    px = argb[ev_pos]
    green = (px >> 8) & 0xFF
    len_sym, len_extra, len_bits = _prefix(np.maximum(ev_len, 1))
    dist_sym, dist_extra, dist_bits = _prefix(np.maximum(dist_code, 1))
    gsym = np.where(ev_kind == 0, green, np.where(ev_kind == 1, 280 + key[ev_pos], 256 + len_sym))
    g_of = groups[ev_pos] if groups is not None else np.zeros(len(ev_pos), np.int64)
    num_groups = 1 if groups is None else int(groups.max()) + 1
    alphabet = (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256, 256, 40)
    lit = ev_kind == 0
    ref = ev_kind == 2
    syms = (gsym, (px >> 16) & 0xFF, px & 0xFF, (px >> 24) & 0xFF, dist_sym)
    live = (np.ones(len(ev_pos), bool), lit, lit, lit, ref)
    tables = []
    for g in range(num_groups):
        mine = g_of == g
        codes = []
        for j in range(5):
            hist = np.bincount(syms[j][mine & live[j]].astype(np.int64), minlength=alphabet[j])
            codes.append(_write_code(bw, hist))
        tables.append(codes)
    # Each event's items: literal (green, red, blue, alpha), cache (green),
    # reference (green, length's extra bits, distance, its extra bits).
    count = np.where(ev_kind == 1, 1, 4)
    start = np.cumsum(count) - count
    total = int(count.sum())
    vals = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)
    code_val = [np.stack([tables[g][j][0] for g in range(num_groups)]) for j in range(5)]
    code_len = [np.stack([tables[g][j][1] for g in range(num_groups)]) for j in range(5)]
    vals[start] = code_val[0][g_of, gsym]
    lens[start] = code_len[0][g_of, gsym]
    for j, field in ((1, syms[1]), (2, syms[2]), (3, syms[3])):
        idx = np.flatnonzero(lit)
        vals[start[idx] + j] = code_val[j][g_of[idx], field[idx]]
        lens[start[idx] + j] = code_len[j][g_of[idx], field[idx]]
    idx = np.flatnonzero(ref)
    vals[start[idx] + 1], lens[start[idx] + 1] = len_extra[idx], len_bits[idx]
    vals[start[idx] + 2] = code_val[4][g_of[idx], dist_sym[idx]]
    lens[start[idx] + 2] = code_len[4][g_of[idx], dist_sym[idx]]
    vals[start[idx] + 3], lens[start[idx] + 3] = dist_extra[idx], dist_bits[idx]
    bw.put_many(vals, lens)


def _to_argb(rgba: np.ndarray) -> np.ndarray:
    c = rgba.astype(np.uint32)
    return (c[..., 3] << 24) | (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def _channels(argb: np.ndarray) -> np.ndarray:
    """ARGB uint32 [h, w] -> [h, w, 4] int64 in the order a, r, g, b."""
    return np.stack([(argb >> s) & 0xFF for s in (24, 16, 8, 0)], -1).astype(np.int64)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch.astype(np.uint32) & 0xFF
    return (ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8) | ch[..., 3]


def _predictions(a: np.ndarray) -> np.ndarray:
    """The 14 predictor modes' predictions of each pixel from its left (L),
    top (T), top-right (TR, the row's first pixel past its last column) and
    top-left (TL) neighbours, [14, h, w, 4] (channels a, r, g, b)."""
    h, w, _ = a.shape
    L = np.zeros_like(a)
    L[:, 1:] = a[:, :-1]
    T = np.zeros_like(a)
    T[1:] = a[:-1]
    TL = np.zeros_like(a)
    TL[1:, 1:] = a[:-1, :-1]
    TR = np.zeros_like(a)
    TR[1:, :-1] = a[:-1, 1:]
    TR[1:, -1] = a[1:, 0]
    avg = lambda x, y: (x + y) >> 1  # noqa: E731
    black = np.zeros_like(a)
    black[..., 0] = 255
    sel = (np.abs(L - TL) - np.abs(T - TL)).sum(-1, keepdims=True) <= 0
    ave = avg(L, T)
    half = ave + np.trunc((ave - TL) / 2).astype(np.int64)
    return np.stack([black, L, T, TR, TL, avg(avg(L, TR), T), avg(L, TL), avg(L, T), avg(TL, T), avg(T, TR),
                     avg(avg(L, TL), avg(T, TR)), np.where(sel, T, L), np.clip(L + T - TL, 0, 255),
                     np.clip(half, 0, 255)])


def _forward_transform(kind: str, argb: np.ndarray, bw: _Bits, rng: np.random.Generator, opts: dict) -> np.ndarray:
    """Writes one transform's header and data; returns the image it leaves
    (ARGB [h, w'])."""
    h, w = argb.shape
    bw.put(1, 1)
    bw.put(_TRANSFORM_TYPES[kind], 2)
    if kind == "subtract_green":
        ch = _channels(argb)
        ch[..., 1] -= ch[..., 2]
        ch[..., 3] -= ch[..., 2]
        return _pack(ch)
    if kind == "palette":
        colors, index = np.unique(argb.reshape(-1), return_inverse=True)
        if len(colors) > 256:
            raise ValueError(f"colour indexing needs at most 256 colours, not {len(colors)}")
        order = rng.permutation(len(colors)) if opts.get("shuffle_palette") else np.arange(len(colors))
        colors = colors[order]
        index = np.argsort(order)[index].reshape(h, w)
        bits = 0 if len(colors) > 16 else 1 if len(colors) > 4 else 2 if len(colors) > 2 else 3
        bw.put(len(colors) - 1, 8)
        pal = _channels(colors[None])
        delta = pal.copy()
        delta[:, 1:] -= pal[:, :-1]
        _stream(bw, _pack(delta), rng, level0=False, cache_bits=0, backrefs=False)
        per = 1 << bits
        packed_w = -(-w // per)
        padded = np.zeros((h, packed_w * per), np.int64)
        padded[:, :w] = index
        packed = np.zeros((h, packed_w), np.int64)
        for j in range(per):
            packed |= padded[:, j::per] << (j * (8 >> bits))
        return (0xFF000000 | (packed << 8)).astype(np.uint32)
    bits = opts.get("transform_bits", 2)
    bw.put(bits - 2, 3)
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    ch = _channels(argb)
    ty = np.arange(h)[:, None] >> bits
    tx = np.arange(w)[None, :] >> bits
    if kind == "predictor":
        preds = _predictions(ch)
        resid = (ch[None] - preds) & 0xFF
        choice = opts.get("predictor_modes", "best")
        if choice == "best":
            cost = np.minimum(resid, 256 - resid).sum(-1)
            tile = np.zeros((14, th, tw), np.int64)
            np.add.at(tile, (slice(None), np.broadcast_to(ty, (h, w)), np.broadcast_to(tx, (h, w))), cost)
            modes = tile.argmin(0)
        elif choice == "random":
            modes = rng.integers(0, 14, (th, tw))
        else:
            modes = np.resize(np.asarray(choice, np.int64), th * tw).reshape(th, tw)
        mode = np.broadcast_to(modes[ty, tx] & 0xF, (h, w)).copy()
        mode[0, :] = 1
        mode[1:, 0] = 2
        mode[0, 0] = 0
        _stream(bw, (0xFF000000 | (modes.astype(np.uint32) << 8)).astype(np.uint32), rng, level0=False)
        # Modes 14 and 15 predict black, as libwebp reads them.
        mode = np.where(mode >= 14, 0, mode)
        out = np.take_along_axis(resid, mode[None, ..., None], 0)[0]
        return _pack(out)
    # cross colour: each tile's multipliers green-to-red, green-to-blue,
    # red-to-blue as int8
    mult = rng.integers(-32, 33, (th, tw, 3))
    code = (mult[..., 2] & 0xFF) << 16 | (mult[..., 1] & 0xFF) << 8 | (mult[..., 0] & 0xFF)
    _stream(bw, (0xFF000000 | code).astype(np.uint32), rng, level0=False)
    m = mult[ty, tx]
    s8 = lambda v: ((v + 128) & 0xFF) - 128  # noqa: E731
    green, red = s8(ch[..., 2]), s8(ch[..., 1])
    ch[..., 1] = (ch[..., 1] - ((m[..., 0] * green) >> 5)) & 0xFF
    ch[..., 3] = (ch[..., 3] - ((m[..., 1] * green) >> 5) - ((m[..., 2] * red) >> 5)) & 0xFF
    return _pack(ch)


def _stream(bw: _Bits, argb: np.ndarray, rng: np.random.Generator, level0: bool, transforms: Sequence[str] = (),
            cache_bits: int = 0, backrefs: bool = True, meta_bits: Optional[int] = None, opts: Optional[dict] = None):
    """An image stream: at level 0 its transforms and meta codes first."""
    opts = opts or {}
    argb = np.asarray(argb, np.uint32)
    if level0:
        for kind in transforms:
            argb = _forward_transform(kind, argb, bw, rng, opts)
        bw.put(0, 1)
    h, w = argb.shape
    bw.put(int(cache_bits > 0), 1)
    if cache_bits:
        bw.put(cache_bits, 4)
    groups = None
    if level0:
        bw.put(int(meta_bits is not None), 1)
        if meta_bits is not None:
            bw.put(meta_bits - 2, 3)
            mh, mw = -(-h // (1 << meta_bits)), -(-w // (1 << meta_bits))
            tiles = rng.integers(0, opts.get("groups", 3), (mh, mw))
            tiles[0, 0] = 0
            _, tiles = np.unique(tiles, return_inverse=True)  # groups 0..k-1, all used
            tiles = tiles.reshape(mh, mw)
            _stream(bw, (0xFF000000 | (tiles.astype(np.uint32) << 8)).astype(np.uint32), rng, level0=False)
            groups = tiles[np.arange(h)[:, None] >> meta_bits, np.arange(w)[None, :] >> meta_bits].reshape(-1)
    _image_data(bw, argb.reshape(-1), w, cache_bits, backrefs, groups, rng)


def encode_vp8l(rgba: np.ndarray, transforms: Sequence[str] = ("subtract_green", "predictor", "cross_color"),
                cache_bits: int = 0, backrefs: bool = True, meta_bits: Optional[int] = None, seed: int = 0,
                **opts) -> bytes:
    """A VP8L bitstream (the payload of a "VP8L" chunk) of uint8 [H,W,3]
    (opaque) or [H,W,4]. ``transforms`` in the order applied (any of
    "subtract_green", "predictor", "cross_color", "palette", each once);
    ``cache_bits`` 0 or 1-11; ``meta_bits`` 2-9 for meta prefix codes over
    tiles of that size; opts: transform_bits (2-9, predictor and cross
    colour), predictor_modes ("best", "random" or a sequence of modes
    0-15), groups (meta code groups drawn), shuffle_palette."""
    rgba = np.asarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if rgba.shape[-1] == 3:
        rgba = np.concatenate([rgba, np.full((h, w, 1), 255, np.uint8)], -1)
    alpha_is_used = bool((rgba[..., 3] != 255).any())  # the header's bit, which names the mode "RGBA"
    bw = _Bits()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(int(alpha_is_used), 1)
    bw.put(0, 3)
    _stream(bw, _to_argb(rgba), np.random.default_rng(seed), True, transforms, cache_bits, backrefs, meta_bits, opts)
    return bw.tobytes()


# ---------------------------------------------------------------------------
# ALPH
# ---------------------------------------------------------------------------

ALPHA_FILTERS = {"none": 0, "horizontal": 1, "vertical": 2, "gradient": 3}


def _alpha_filtered(alpha: np.ndarray, filt: int) -> np.ndarray:
    """The forward filter whose unfilter libwebp applies: row 0 from the
    left (0 before its first pixel), later rows' first pixel from above."""
    a = alpha.astype(np.int64)
    if filt == 0:
        return alpha.copy()
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if filt == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif filt == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def encode_alph(alpha: np.ndarray, compression: str = "lossless", filter: str = "none", pre_processing: int = 0,
                seed: int = 0, **vp8l_opts) -> bytes:
    """An ALPH chunk's payload for uint8 [H,W]: ``compression`` "raw" or
    "lossless" (VP8L in the green channel, by default colour indexing),
    ``filter`` one of ALPHA_FILTERS."""
    filt = ALPHA_FILTERS[filter]
    data = _alpha_filtered(np.asarray(alpha, np.uint8), filt)
    header = bytes([(1 if compression == "lossless" else 0) | filt << 2 | pre_processing << 4])
    if compression == "raw":
        return header + data.tobytes()
    h, w = data.shape
    argb = (0xFF000000 | (data.astype(np.uint32) << 8)).astype(np.uint32)
    bw = _Bits()
    vp8l_opts.setdefault("transforms", ("palette",))
    transforms = vp8l_opts.pop("transforms")
    _stream(bw, argb, np.random.default_rng(seed), True, transforms, vp8l_opts.pop("cache_bits", 0),
            vp8l_opts.pop("backrefs", True), vp8l_opts.pop("meta_bits", None), vp8l_opts)
    return header + bw.tobytes()


# ---------------------------------------------------------------------------
# VP8 key frames
# ---------------------------------------------------------------------------

B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
_ZIGZAG = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# The 4x4 mode tree (libwebp's numbering): node i reads prob[i]; a leaf is -mode.
_BMODE_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU)


@functools.lru_cache(maxsize=1)
def _vp8_tables():
    """(default token probabilities [4,8,3,11], their update probabilities,
    4x4 mode probabilities [10,10,9], DC steps [128], AC steps [128])."""
    from mlinerf_tpu_torch.utils import image_webp

    lib = image_webp._lib()
    probas = np.zeros(1056 * 2 + 900, np.uint8)
    steps = np.zeros(256, np.uint16)
    fn = lib.webp_vp8_tables
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn(probas.ctypes.data, steps.ctypes.data)
    return (probas[:1056].reshape(4, 8, 3, 11), probas[1056:2112].reshape(4, 8, 3, 11),
            probas[2112:].reshape(10, 10, 9), steps[:128].astype(np.int64), steps[128:].astype(np.int64))


def _bmode_paths():
    """Each 4x4 mode's path through the tree: [(prob index, bit), ...]."""
    paths = {}

    def walk(node, path):
        for bit in (0, 1):
            nxt = _BMODE_TREE[2 * node + bit]
            step = path + [(node, bit)]
            if nxt > 0:
                walk(nxt, step)
            else:
                paths[-nxt] = step

    walk(0, [])
    return paths


_BMODE_PATHS = _bmode_paths()


class _BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range = 255
        self.bottom = 0
        self.bit_count = 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def put_value(self, value: int, nbits: int):
        for k in range(nbits - 1, -1, -1):
            self.put((value >> k) & 1, 128)

    def put_signed(self, value: int, nbits: int):
        self.put_value(abs(value), nbits)
        self.put(int(value < 0), 128)

    def put_optional_signed(self, value: int, nbits: int):
        self.put(int(value != 0), 128)
        if value:
            self.put_signed(value, nbits)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _fdct(d: np.ndarray) -> np.ndarray:
    """libwebp's forward 4x4 transform of residuals [N,4,4] -> [N,16]."""
    d = d.astype(np.int64)
    a0, a1 = d[..., 0] + d[..., 3], d[..., 1] + d[..., 2]
    a2, a3 = d[..., 1] - d[..., 2], d[..., 0] - d[..., 3]
    tmp = np.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9, (a0 - a1) * 8,
                    (a3 * 2217 - a2 * 5352 + 937) >> 9], -1)  # [N, row, 4]
    b0, b1 = tmp[:, 0] + tmp[:, 3], tmp[:, 1] + tmp[:, 2]
    b2, b3 = tmp[:, 1] - tmp[:, 2], tmp[:, 0] - tmp[:, 3]
    out = np.stack([(b0 + b1 + 7) >> 4, ((b2 * 2217 + b3 * 5352 + 12000) >> 16) + (b3 != 0), (b0 - b1 + 7) >> 4,
                    (b3 * 2217 - b2 * 5352 + 51000) >> 16], 1)  # [N, row(freq), col]
    return out.reshape(-1, 16)


def _idct_add(coeffs: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """The decoder's TransformOne: dequantised coefficients [N,16] added to
    predictions [N,4,4] -> uint8 [N,4,4]."""
    c = coeffs.astype(np.int64).reshape(-1, 4, 4)
    mul1 = lambda a: ((a * 20091) >> 16) + a  # noqa: E731
    mul2 = lambda a: (a * 35468) >> 16  # noqa: E731
    i0, i4, i8, i12 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]  # rows of raster order: in[0..3], in[4..7], ...
    a, b = i0 + i8, i0 - i8
    cc, dd = mul2(i4) - mul1(i12), mul1(i4) + mul2(i12)
    tmp = np.stack([a + dd, b + cc, b - cc, a - dd], 1)  # tmp[N, k, col]: column col's vertical outputs
    t0, t4, t8, t12 = tmp[:, :, 0], tmp[:, :, 1], tmp[:, :, 2], tmp[:, :, 3]
    dc = t0 + 4
    a, b = dc + t8, dc - t8
    cc, dd = mul2(t4) - mul1(t12), mul1(t4) + mul2(t12)
    res = np.stack([a + dd, b + cc, b - cc, a - dd], -1) >> 3  # [N, row, x]
    return np.clip(pred.astype(np.int64) + res, 0, 255).astype(np.uint8)


def _fwht(dc: np.ndarray) -> np.ndarray:
    x = dc.astype(np.int64).reshape(4, 4)  # [block row, block col]
    a0, a1 = x[:, 0] + x[:, 2], x[:, 1] + x[:, 3]
    a2, a3 = x[:, 1] - x[:, 3], x[:, 0] - x[:, 2]
    tmp = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], 1)  # [i, 4]
    a0, a1 = tmp[0] + tmp[2], tmp[1] + tmp[3]
    a2, a3 = tmp[1] - tmp[3], tmp[0] - tmp[2]
    return (np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1]) >> 1).reshape(16)


def _iwht(c: np.ndarray) -> np.ndarray:
    x = c.astype(np.int64)
    tmp = np.zeros(16, np.int64)
    for i in range(4):
        a0, a1 = x[0 + i] + x[12 + i], x[4 + i] + x[8 + i]
        a2, a3 = x[4 + i] - x[8 + i], x[0 + i] - x[12 + i]
        tmp[0 + i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = np.zeros(16, np.int64)
    for i in range(4):
        dc = tmp[0 + i * 4] + 3
        a0, a1 = dc + tmp[3 + i * 4], tmp[1 + i * 4] + tmp[2 + i * 4]
        a2, a3 = tmp[1 + i * 4] - tmp[2 + i * 4], dc - tmp[3 + i * 4]
        out[4 * i:4 * i + 4] = [(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3]
    return out


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, e: np.ndarray) -> np.ndarray:
    """A 4x4 block's prediction from its edge e = [L3, L2, L1, L0, P, A0..A7]
    (left from the bottom up, top-left, top with top-right)."""
    L3, L2, L1, L0, P = (int(v) for v in e[:5])
    A = [int(v) for v in e[5:]]
    I, J, K, L, X = L0, L1, L2, L3, P
    out = np.zeros((4, 4), np.int64)
    if mode == B_DC:
        out[:] = (sum(A[:4]) + I + J + K + L + 4) >> 3
    elif mode == B_TM:
        out[:] = np.clip(np.array([I, J, K, L])[:, None] + np.array(A[:4])[None] - X, 0, 255)
    elif mode == B_VE:
        out[:] = [_avg3(X, A[0], A[1]), _avg3(A[0], A[1], A[2]), _avg3(A[1], A[2], A[3]), _avg3(A[2], A[3], A[4])]
    elif mode == B_HE:
        out[:] = np.array([_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)])[:, None]
    else:
        # the diagonal modes over the edge, as the spec's B_*_PRED lists them
        E = [L, K, J, I, X] + A[:4]
        B = [[0] * 4 for _ in range(4)]
        if mode == B_LD:
            for r in range(4):
                for c in range(4):
                    B[r][c] = _avg3(A[r + c], A[r + c + 1], A[min(r + c + 2, 7)])
        elif mode == B_RD:
            for r in range(4):
                for c in range(4):
                    k = 4 - r + c
                    B[r][c] = _avg3(E[k - 1], E[k], E[k + 1])
        elif mode == B_VR:
            B[3][0] = _avg3(E[1], E[2], E[3])
            B[2][0] = _avg3(E[2], E[3], E[4])
            B[3][1] = B[1][0] = _avg3(E[3], E[4], E[5])
            B[2][1] = B[0][0] = _avg2(E[4], E[5])
            B[3][2] = B[1][1] = _avg3(E[4], E[5], E[6])
            B[2][2] = B[0][1] = _avg2(E[5], E[6])
            B[3][3] = B[1][2] = _avg3(E[5], E[6], E[7])
            B[2][3] = B[0][2] = _avg2(E[6], E[7])
            B[1][3] = _avg3(E[6], E[7], E[8])
            B[0][3] = _avg2(E[7], E[8])
        elif mode == B_VL:
            B[0][0] = _avg2(A[0], A[1])
            B[1][0] = _avg3(A[0], A[1], A[2])
            B[2][0] = B[0][1] = _avg2(A[1], A[2])
            B[1][1] = B[3][0] = _avg3(A[1], A[2], A[3])
            B[2][1] = B[0][2] = _avg2(A[2], A[3])
            B[3][1] = B[1][2] = _avg3(A[2], A[3], A[4])
            B[2][2] = B[0][3] = _avg2(A[3], A[4])
            B[3][2] = B[1][3] = _avg3(A[3], A[4], A[5])
            B[2][3] = _avg3(A[4], A[5], A[6])
            B[3][3] = _avg3(A[5], A[6], A[7])
        elif mode == B_HD:
            B[3][0] = _avg2(E[0], E[1])
            B[3][1] = _avg3(E[0], E[1], E[2])
            B[2][0] = B[3][2] = _avg2(E[1], E[2])
            B[2][1] = B[3][3] = _avg3(E[1], E[2], E[3])
            B[2][2] = B[1][0] = _avg2(E[2], E[3])
            B[2][3] = B[1][1] = _avg3(E[2], E[3], E[4])
            B[1][2] = B[0][0] = _avg2(E[3], E[4])
            B[1][3] = B[0][1] = _avg3(E[3], E[4], E[5])
            B[0][2] = _avg3(E[4], E[5], E[6])
            B[0][3] = _avg3(E[5], E[6], E[7])
        else:  # B_HU
            B[0][0] = _avg2(I, J)
            B[0][1] = _avg3(I, J, K)
            B[0][2] = B[1][0] = _avg2(J, K)
            B[0][3] = B[1][1] = _avg3(J, K, L)
            B[1][2] = B[2][0] = _avg2(K, L)
            B[1][3] = B[2][1] = _avg3(K, L, L)
            B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] = L
        out[:] = B
    return out


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, tl: int, size: int, has_top: bool,
                has_left: bool) -> np.ndarray:
    """A 16x16 or 8x8 prediction; DC over the edges inside the frame."""
    if mode == B_TM:
        return np.clip(left[:, None].astype(np.int64) + top[None].astype(np.int64) - tl, 0, 255)
    if mode == B_VE:
        return np.broadcast_to(top[None], (size, size)).astype(np.int64)
    if mode == B_HE:
        return np.broadcast_to(left[:, None], (size, size)).astype(np.int64)
    shift = 4 if size == 16 else 3
    if has_top and has_left:
        dc = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
    elif has_top:
        dc = (int(top.sum()) + size // 2) >> shift
    elif has_left:
        dc = (int(left.sum()) + size // 2) >> shift
    else:
        dc = 128
    return np.full((size, size), dc, np.int64)


def _quantize(c: np.ndarray, dc_step: int, ac_step: int, first: int = 0) -> np.ndarray:
    """Coefficients [N,16] (raster) -> levels [N,16] in zigzag order."""
    z = c[:, _ZIGZAG]
    step = np.full(16, ac_step)
    step[0] = dc_step
    q = np.sign(z) * ((np.abs(z) + step // 2) // step)
    q[:, :first] = 0
    return np.clip(q, -2048, 2048).astype(np.int64)


def _dequant(levels: np.ndarray, dc_step: int, ac_step: int) -> np.ndarray:
    """Levels [N,16] in zigzag order -> coefficients [N,16] in raster order."""
    out = np.zeros_like(levels)
    step = np.full(16, ac_step)
    step[0] = dc_step
    out[:, _ZIGZAG] = levels * step
    return out


class _VP8Frame:
    """One key frame: modes and levels chosen macroblock by macroblock from
    a reconstruction that matches the decoder's, then written."""

    def __init__(self, rgb: np.ndarray, q: int, segments: int, intra: str, bpred_share: float, bpred_modes: str,
                 rng: np.random.Generator):
        self.h, self.w = rgb.shape[:2]
        self.mb_w, self.mb_h = -(-self.w // 16), -(-self.h // 16)
        ph, pw = self.mb_h * 16, self.mb_w * 16
        src = np.pad(rgb.astype(np.int64), ((0, ph - self.h), (0, pw - self.w), (0, 0)), mode="edge")
        r, g, b = src[..., 0], src[..., 1], src[..., 2]
        self.Y = np.clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 0, 255)
        sub = src.reshape(ph // 2, 2, pw // 2, 2, 3).sum((1, 3))
        r, g, b = sub[..., 0], sub[..., 1], sub[..., 2]
        self.U = np.clip(((-38 * r - 74 * g + 112 * b + 512) >> 10) + 128, 0, 255)
        self.V = np.clip(((112 * r - 94 * g - 18 * b + 512) >> 10) + 128, 0, 255)
        self.rec = [np.zeros_like(self.Y), np.zeros_like(self.U), np.zeros_like(self.V)]
        _, _, _, dc_tab, ac_tab = _vp8_tables()
        self.segments = segments
        offsets = (0, 12, -8, 24)[:segments]
        self.seg_q = [int(np.clip(q + o, 0, 127)) for o in offsets]
        self.steps = []
        for sq in self.seg_q:
            y2ac = max((ac_tab[sq] * 101581) >> 16, 8)
            self.steps.append(dict(y1=(dc_tab[sq], ac_tab[sq]), y2=(dc_tab[sq] * 2, y2ac),
                                   uv=(dc_tab[min(sq, 117)], ac_tab[sq])))
        self.intra, self.bpred_share, self.bpred_modes, self.rng = intra, bpred_share, bpred_modes, rng
        self.mbs = []
        for mb_y in range(self.mb_h):
            for mb_x in range(self.mb_w):
                self.mbs.append(self._code_mb(mb_x, mb_y))

    def _edges(self, plane: np.ndarray, mb_x: int, mb_y: int, size: int):
        """(top, left, top-left, top-right 4) of a macroblock as the decoder
        sees them: 127 above the frame, 129 left of it."""
        x0, y0 = mb_x * size, mb_y * size
        top = plane[y0 - 1, x0:x0 + size] if mb_y else np.full(size, 127)
        left = plane[y0:y0 + size, x0 - 1] if mb_x else np.full(size, 129)
        tl = 127 if mb_y == 0 else (129 if mb_x == 0 else int(plane[y0 - 1, x0 - 1]))
        if mb_y == 0:
            tr = np.full(4, 127)
        elif mb_x == self.mb_w - 1:
            tr = np.full(4, plane[y0 - 1, x0 + size - 1])
        else:
            tr = plane[y0 - 1, x0 + size:x0 + size + 4]
        return top.astype(np.int64), left.astype(np.int64), tl, tr.astype(np.int64)

    def _code_mb(self, mb_x: int, mb_y: int) -> dict:
        seg = int(self.rng.integers(0, self.segments)) if self.segments > 1 else 0
        steps = self.steps[seg]
        x0, y0 = mb_x * 16, mb_y * 16
        src = self.Y[y0:y0 + 16, x0:x0 + 16]
        top, left, tl, tr = self._edges(self.rec[0], mb_x, mb_y, 16)
        use_b = self.intra == "bpred" or (self.intra == "mixed" and self.rng.random() < self.bpred_share)
        mb = {"segment": seg, "is_i4x4": use_b}
        if use_b:
            work = np.zeros((17, 21), np.int64)  # row 0: top-left, top, top-right; column 0: left
            work[0, 0], work[0, 1:17], work[0, 17:21] = tl, top, tr
            work[1:, 0] = left
            for r in (4, 8, 12):
                work[r, 17:21] = tr
            modes, levels = [], []
            for n in range(16):
                by, bx = divmod(n, 4)
                e = np.concatenate([work[4 * by + 4:4 * by:-1, 4 * bx], [work[4 * by, 4 * bx]],
                                    work[4 * by, 4 * bx + 1:4 * bx + 9]])
                block = src[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
                if self.bpred_modes == "random":
                    mode = int(self.rng.integers(0, 10))
                    pred = _pred4(mode, e)
                else:
                    preds = [_pred4(m, e) for m in range(10)]
                    mode = int(np.argmin([np.abs(block - p).sum() for p in preds]))
                    pred = preds[mode]
                lv = _quantize(_fdct((block - pred)[None]), *steps["y1"])
                rec = _idct_add(_dequant(lv, *steps["y1"]), pred[None])[0]
                work[4 * by + 1:4 * by + 5, 4 * bx + 1:4 * bx + 5] = rec
                modes.append(mode)
                levels.append(lv[0])
            mb["modes"] = modes
            mb["y"] = np.stack(levels)
            self.rec[0][y0:y0 + 16, x0:x0 + 16] = work[1:, 1:17]
        else:
            preds = {m: _pred_block(m, top, left, tl, 16, mb_y > 0, mb_x > 0) for m in (B_DC, B_TM, B_VE, B_HE)}
            mode = min(preds, key=lambda m: np.abs(src - preds[m]).sum())
            pred = preds[mode]
            blocks = (src - pred).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
            coeffs = _fdct(blocks)
            y2 = _quantize(_fwht(coeffs[:, 0])[None], *steps["y2"])
            lv = _quantize(coeffs, *steps["y1"], first=1)
            deq = _dequant(lv, *steps["y1"])
            deq[:, 0] = _iwht(_dequant(y2, *steps["y2"])[0])
            pblocks = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
            rec = _idct_add(deq, pblocks).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
            self.rec[0][y0:y0 + 16, x0:x0 + 16] = rec
            mb.update(ymode=mode, y2=y2[0], y=lv)
        # chroma: one mode for both planes
        uv_src = [self.U[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8], self.V[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8]]
        uv_edges = [self._edges(self.rec[k], mb_x, mb_y, 8)[:3] for k in (1, 2)]
        best, best_cost = None, None
        for m in (B_DC, B_TM, B_VE, B_HE):
            p = [_pred_block(m, *uv_edges[k], 8, mb_y > 0, mb_x > 0) for k in range(2)]
            cost = sum(np.abs(uv_src[k] - p[k]).sum() for k in range(2))
            if best_cost is None or cost < best_cost:
                best, best_cost, best_p = m, cost, p
        mb["uvmode"] = best
        uv_levels = []
        for k in range(2):
            blocks = (uv_src[k] - best_p[k]).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)
            lv = _quantize(_fdct(blocks), *steps["uv"])
            pb = best_p[k].reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)
            rec = _idct_add(_dequant(lv, *steps["uv"]), pb).reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
            self.rec[k + 1][y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = rec
            uv_levels.append(lv)
        mb["uv"] = np.concatenate(uv_levels)
        mb["zero"] = not (mb["y"].any() or mb["uv"].any() or (not use_b and mb["y2"].any()))
        return mb


def _write_coeffs(be: _BoolEncoder, proba, t: int, ctx: int, levels: np.ndarray, first: int) -> int:
    """One block's tokens (levels in zigzag order) as GetCoeffs reads them;
    returns what the decoder returns (the index past the last non-zero
    level, or ``first`` for none)."""
    nz = np.flatnonzero(levels[first:])
    last = first + int(nz[-1]) if len(nz) else -1
    n = first
    p = proba[t][_BANDS[n]][ctx]
    if last < 0:
        be.put(0, p[0])
        return first
    while n < 16:
        be.put(1, p[0])
        while levels[n] == 0:
            be.put(0, p[1])
            n += 1
            p = proba[t][_BANDS[n]][0]
        be.put(1, p[1])
        v = abs(int(levels[n]))
        nxt = proba[t][_BANDS[n + 1]]
        if v == 1:
            be.put(0, p[2])
            p_next = nxt[1]
        else:
            be.put(1, p[2])
            if v <= 4:
                be.put(0, p[3])
                if v == 2:
                    be.put(0, p[4])
                else:
                    be.put(1, p[4])
                    be.put(v - 3, p[5])
            elif v <= 10:
                be.put(1, p[3])
                be.put(0, p[6])
                if v <= 6:
                    be.put(0, p[7])
                    be.put(v - 5, 159)
                else:
                    be.put(1, p[7])
                    be.put((v - 7) >> 1, 165)
                    be.put((v - 7) & 1, 145)
            else:
                be.put(1, p[3])
                be.put(1, p[6])
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                be.put(cat >> 1, p[8])
                be.put(cat & 1, p[9 + (cat >> 1)])
                extra = v - (3 + (8 << cat))
                tab = _CATS[cat]
                for k, prob in enumerate(tab):
                    be.put((extra >> (len(tab) - 1 - k)) & 1, prob)
            p_next = nxt[2]
        be.put(int(levels[n] < 0), 128)
        n += 1
        p = p_next
        if n == 16:
            return 16
        if n > last:
            be.put(0, p[0])
            return n
    return 16


def encode_vp8(rgb: np.ndarray, quality: int = 75, filter: str = "normal", level: Optional[int] = None,
               sharpness: int = 0, partitions: int = 1, segments: int = 1, intra: str = "mixed",
               bpred_share: float = 0.3, bpred_modes: str = "best", skip_proba: bool = True, lf_delta: Optional[Tuple[int, int]] = None,
               prob_updates: int = 0, seed: int = 0) -> bytes:
    """A VP8 key frame (the payload of a "VP8 " chunk) of uint8 [H,W,3].
    ``quality`` 0-100 sets the base quantizer; ``filter`` "normal",
    "simple" or "none" at ``level`` (0-63, default from the quantizer) and
    ``sharpness`` 0-7; ``partitions`` 1, 2, 4 or 8; ``segments`` 1-4 (each
    with its own quantizer and filter level, drawn per macroblock);
    ``intra`` "i16", "bpred" or "mixed" (``bpred_share`` of the macroblocks
    B_PRED, drawn);
    ``bpred_modes`` "best" or "random"; ``lf_delta`` (reference, B_PRED
    mode) loop-filter deltas; ``prob_updates`` token probabilities replaced
    through the header (drawn)."""
    rgb = np.asarray(rgb, np.uint8)[..., :3]
    h, w = rgb.shape[:2]
    rng = np.random.default_rng(seed)
    q = int(np.clip(round((100 - quality) * 127 / 100), 0, 127))
    frame = _VP8Frame(rgb, q, segments, intra, bpred_share, bpred_modes, rng)
    proba0, update_proba, bmodes_proba, _, _ = _vp8_tables()
    proba = proba0.astype(np.int64).copy()
    updates = []
    for _ in range(prob_updates):
        idx = tuple(int(rng.integers(0, s)) for s in proba.shape)
        proba[idx] = int(rng.integers(1, 256))
        updates.append(idx)
    if level is None:
        level = 0 if filter == "none" else min(63, 4 + q // 3)
    be = _BoolEncoder()
    be.put_value(0, 1)  # colour space
    be.put_value(0, 1)  # clamping type
    be.put_value(int(segments > 1), 1)
    counts = np.bincount([mb["segment"] for mb in frame.mbs], minlength=4)
    if segments > 1:
        be.put_value(1, 1)  # update the map
        be.put_value(1, 1)  # update the data
        be.put_value(1, 1)  # absolute values
        for s in range(4):
            be.put_optional_signed(frame.seg_q[s] if s < segments else 0, 7)
        for s in range(4):
            be.put_optional_signed(int(np.clip(level + 6 * s, 0, 63)) if s < segments else 0, 6)
        total = max(counts.sum(), 1)
        seg_probs = [int(np.clip(255 * (counts[0] + counts[1]) / total, 1, 255)),
                     int(np.clip(255 * counts[0] / max(counts[0] + counts[1], 1), 1, 255)),
                     int(np.clip(255 * counts[2] / max(counts[2] + counts[3], 1), 1, 255))]
        for p in seg_probs:
            be.put_value(1, 1)
            be.put_value(p, 8)
    be.put_value(int(filter == "simple"), 1)
    be.put_value(level, 6)
    be.put_value(sharpness, 3)
    be.put_value(int(lf_delta is not None), 1)
    if lf_delta is not None:
        be.put_value(1, 1)
        for v in (lf_delta[0], 0, 0, 0, lf_delta[1], 0, 0, 0):  # reference deltas, then mode deltas
            be.put_optional_signed(v, 6)
    be.put_value({1: 0, 2: 1, 4: 2, 8: 3}[partitions], 2)
    be.put_value(q, 7)
    for _ in range(5):  # no quantizer deltas
        be.put_value(0, 1)
    be.put_value(0, 1)  # refresh entropy probabilities
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    changed = (t, b, c, p) in updates
                    be.put(int(changed), int(update_proba[t, b, c, p]))
                    if changed:
                        be.put_value(int(proba[t, b, c, p]), 8)
    skip_p = 0
    if skip_proba:
        zero = sum(mb["zero"] for mb in frame.mbs)
        skip_p = int(np.clip(round(255 * (1 - zero / len(frame.mbs))), 1, 254))
    be.put_value(int(skip_proba), 1)
    if skip_proba:
        be.put_value(skip_p, 8)
    # modes, in partition 0
    intra_t = [B_DC] * (4 * frame.mb_w)
    for i, mb in enumerate(frame.mbs):
        mb_x = i % frame.mb_w
        if mb_x == 0:
            intra_l = [B_DC] * 4
        if segments > 1:
            s = mb["segment"]
            be.put(s >> 1, seg_probs[0])
            be.put(s & 1, seg_probs[1 + (s >> 1)])
        if skip_proba:
            be.put(int(mb["zero"]), skip_p)
        be.put(int(not mb["is_i4x4"]), 145)
        if not mb["is_i4x4"]:
            m = mb["ymode"]
            if m in (B_TM, B_HE):
                be.put(1, 156)
                be.put(int(m == B_TM), 128)
            else:
                be.put(0, 156)
                be.put(int(m == B_VE), 163)
            intra_t[4 * mb_x:4 * mb_x + 4] = [m] * 4
            intra_l = [m] * 4
        else:
            for n, m in enumerate(mb["modes"]):
                y, x = divmod(n, 4)
                prob = bmodes_proba[intra_t[4 * mb_x + x], intra_l[y]]
                for node, bit in _BMODE_PATHS[m]:
                    be.put(bit, int(prob[node]))
                intra_t[4 * mb_x + x] = m
                intra_l[y] = m
        u = mb["uvmode"]
        be.put(int(u != B_DC), 142)
        if u != B_DC:
            be.put(int(u != B_VE), 114)
            if u != B_VE:
                be.put(int(u == B_TM), 183)
    first_part = be.finish()
    # tokens, macroblock row r in partition r % partitions
    parts = [_BoolEncoder() for _ in range(partitions)]
    proba = proba.tolist()
    top_nz = [0] * frame.mb_w
    top_nz_dc = [0] * frame.mb_w
    for i, mb in enumerate(frame.mbs):
        mb_y, mb_x = divmod(i, frame.mb_w)
        tb = parts[mb_y % partitions]
        if mb_x == 0:
            left_nz = left_nz_dc = 0
        if skip_proba and mb["zero"]:
            top_nz[mb_x] = left_nz = 0
            if not mb["is_i4x4"]:
                top_nz_dc[mb_x] = left_nz_dc = 0
            continue
        if not mb["is_i4x4"]:
            nz = _write_coeffs(tb, proba, 1, top_nz_dc[mb_x] + left_nz_dc, mb["y2"], 0)
            top_nz_dc[mb_x] = left_nz_dc = int(nz > 0)
            first, ac_type = 1, 0
        else:
            first, ac_type = 0, 3
        tnz, lnz = top_nz[mb_x] & 0x0F, left_nz & 0x0F
        for y in range(4):
            lbit = lnz & 1
            for x in range(4):
                nz = _write_coeffs(tb, proba, ac_type, lbit + (tnz & 1), mb["y"][4 * y + x], first)
                lbit = int(nz > first)
                tnz = (tnz >> 1) | (lbit << 7)
            tnz >>= 4
            lnz = (lnz >> 1) | (lbit << 7)
        out_t, out_l = tnz, lnz >> 4
        for ch in (0, 2):
            tnz = top_nz[mb_x] >> (4 + ch)
            lnz = left_nz >> (4 + ch)
            for y in range(2):
                lbit = lnz & 1
                for x in range(2):
                    nz = _write_coeffs(tb, proba, 2, lbit + (tnz & 1), mb["uv"][2 * ch + 2 * y + x], 0)
                    lbit = int(nz > 0)
                    tnz = (tnz >> 1) | (lbit << 3)
                tnz >>= 2
                lnz = (lnz >> 1) | (lbit << 5)
            out_t |= (tnz << 4) << ch
            out_l |= (lnz & 0xF0) << ch
        top_nz[mb_x], left_nz = out_t & 0xFF, out_l & 0xFF
    tokens = [p.finish() for p in parts]
    sizes = b"".join(struct.pack("<I", len(t))[:3] for t in tokens[:-1])
    tag = (len(first_part) << 5) | (1 << 4)  # key frame, profile 0, shown
    header = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", w, h)
    return header + first_part + sizes + b"".join(tokens)


# ---------------------------------------------------------------------------
# The RIFF container
# ---------------------------------------------------------------------------


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(chunks: Sequence[bytes]) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))
