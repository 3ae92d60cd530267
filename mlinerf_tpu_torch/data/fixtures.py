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
baseline encoder below, which exists for these stand-ins only.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

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
    """(code, length) of every symbol of a table, canonical as T.81 C.2."""
    counts, symbols = _HUFFMAN_TABLES[table]
    code_of, length_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            code_of[symbols[k]], length_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, length_of


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


def encode_jpeg(img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0", ycck: bool = False) -> bytes:
    """A baseline JPEG of ``img`` uint8 [H,W] or [H,W,C]: C = 1 (grey), 3
    (RGB, stored as JFIF YCbCr with chroma subsampled as ``subsampling``,
    see JPEG_SUBSAMPLING) or 4 with ``ycck`` (Adobe YCCK: the first three
    channels as RGB, the fourth stored as is). The Annex K tables, the
    quantisation tables scaled to ``quality`` (1-100) as the IJG encoder
    scales them, a float DCT, edges replicated to whole MCUs. For stand-ins
    only: no loader reads through it."""
    img = np.asarray(img, np.uint8)
    img = img[..., None] if img.ndim == 2 else img
    h, w, c = img.shape
    if c not in (1, 3) and not (c == 4 and ycck):
        raise ValueError(f"encode_jpeg: {c} channels (1, 3, or 4 with ycck)")
    planes = [img[..., i].astype(np.float32) for i in range(c)]
    if c >= 3:  # RGB -> YCbCr (T.871); a fourth channel passes
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
    coefs, order, comp_of = [], [], []
    offset = 0
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
        coefs.append(q)
        # Block ids in MCU order: each MCU holds this component's fv x fh blocks.
        ids = offset + np.arange(bh * bw).reshape(mcuy, fv, mcux, fh).transpose(0, 2, 1, 3).reshape(mcuy * mcux, -1)
        order.append(ids)
        comp_of.append(np.full(bh * bw, ci))
        offset += bh * bw
    order = np.concatenate(order, axis=1).reshape(-1)
    z = np.concatenate(coefs)[order]
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
    entropy = _pack_bits((code << size) | bits, length + size)
    out = [b"\xff\xd8"]
    if ycck:
        out.append(_segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2])))
    else:
        out.append(_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    for t in sorted(set(tables)):
        out.append(_segment(0xDB, bytes([t]) + bytes(qtables[t].astype(np.uint8)[_ZIGZAG].tolist())))
    frame = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([c])
    frame += b"".join(bytes([ci + 1, (fh << 4) | fv, tables[ci]]) for ci, (fh, fv) in enumerate(factors))
    out.append(_segment(0xC0, frame))
    for (cls, ident), (counts, symbols) in _HUFFMAN_TABLES.items():
        if ident in tables:
            out.append(_segment(0xC4, bytes([(cls << 4) | ident] + counts) + symbols))
    scan = bytes([c]) + b"".join(bytes([ci + 1, (t << 4) | t]) for ci, t in enumerate(tables)) + bytes([0, 63, 0])
    out += [_segment(0xDA, scan), entropy, b"\xff\xd9"]
    return b"".join(out)


def save_jpeg(path: str, img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0"):
    """Write ``img`` with :func:`encode_jpeg`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))


def _saver(save: Optional[Saver], image_format: str, seed: int) -> Saver:
    """``save``, or the default writer of ``image_format``: PNG with every
    row filter, or JPEG as a camera writes it (4:2:0, quality 90)."""
    if image_format not in ("png", "jpeg"):
        raise ValueError(f"image_format {image_format!r}: png or jpeg")
    return save or (save_jpeg if image_format == "jpeg" else filtered_saver(seed))


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


def write_point_light(root: str, image_size: int = 512, train: int = 4, val: int = 2, lights: int = 2,
                      source: str = "mli", save: Optional[Saver] = None, seed: int = 0,
                      image_format: str = "png") -> Dict[str, str]:
    """A point-light scene under ``root``, ``transforms_{train,val}.json``
    with ``pl_pos`` per frame. ``source="mli"``: the MLI-synthetic layout,
    ``camera_angle_x`` and RGBA ``<file_path>{Img,Ref,Sha,Res}.png`` (alpha
    = coverage); ``source="nrhints"``: NRHints', ``camera_intrinsics`` and
    one RGB ``<file_path><file_ext>`` per frame, ``file_ext`` ".png", or
    ".jpg" with ``image_format="jpeg"``. Returns {split: annotation path}."""
    if image_format == "jpeg" and source != "nrhints":
        raise ValueError("image_format='jpeg' is NRHints' layout (source='nrhints'); MLI's frames are RGBA PNGs")
    save = _saver(save, image_format, seed)
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
                frame.update(file_path=f"{split}/{i:03d}", file_ext=".jpg" if image_format == "jpeg" else ".png")
                save(os.path.join(root, frame["file_path"] + frame["file_ext"]), _to_uint8(img))
                continue
            frame["file_path"] = f"{split}/{i:03d}_"
            alpha = _to_uint8(mask)
            res = np.zeros_like(ref)
            for key, value in (("Img", img), ("Ref", ref), ("Sha", sha), ("Res", res)):
                rgb = _to_uint8(np.broadcast_to(value, ref.shape))
                save(os.path.join(root, frame["file_path"] + key + ".png"), np.concatenate([rgb, alpha], -1))
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
