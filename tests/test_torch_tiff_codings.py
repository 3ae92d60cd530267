"""The TIFF codings Pillow 12.1 reads through its libtiff 4.7's other codecs
(CCITT RLE, RLEW, Group 3 1D and 2D, Group 4, JPEG, old-style JPEG, LZMA,
ZSTD, ThunderScan, and YCbCr on each of Pillow's three routes: its raw
reader, libtiff's strips with libjpeg's conversion, libtiff's
TIFFRGBAImage), read by the port (utils/image_containers.py,
utils/tiff_rgba.py, utils/zstd.py and the host libraries under csrc/) as
Pillow and the JAX package's ``load_image`` read them, bitwise (tolerance
0), with and without ``size``: the committed corpus (the manifest's
``tiff_codings``), seeded random files per coding, files cut short and
files with flipped bits (the port fails where Pillow fails), the codings
Pillow refuses here and old-style JPEG's refusals (each names the coding
and why), and the fixture encoders (data/tiff_encode.py) read back by
Pillow to their source."""

import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import CORPUS, MANIFEST, camera_like, pillow_entry, resize_sizes, sha256
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures, tiff_encode
from mlinerf_tpu_torch.utils import image_containers
from mlinerf_tpu_torch.utils.image_io import load_image, read_image, resize

with open(MANIFEST) as _f:
    CODINGS = json.load(_f)["tiff_codings"]


def _pillow(path):
    with Image.open(path) as im:
        arr = np.asarray(im)
        return arr.reshape(arr.shape + (1,) * (3 - arr.ndim)), im.mode


def _pillow_or_none(path):
    try:
        return _pillow(path)[0]
    except Exception:
        return None


def _assert_like_pillow_and_jax(path, sizes):
    got, mode = read_image(path)
    want, want_mode = _pillow(path)
    assert mode == want_mode and got.dtype == want.dtype and got.shape == want.shape, (mode, want_mode)
    assert np.array_equal(got, want)
    for size in [None, *sizes]:
        a, b = load_image(path, size), jax_load_image(path, size)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (size, a.shape, b.shape)
        assert np.array_equal(a, b), (path, size)
    return got


@pytest.mark.parametrize("name", sorted(CODINGS))
def test_tiff_coding_corpus_reads_like_jax_bitwise(name):
    """Pillow still reads each file to its manifest entry (the card's gate),
    and the port reads it to the same array and resizes, as load_image of
    the JAX package does."""
    path = os.path.join(CORPUS, name)
    entry = CODINGS[name]
    assert pillow_entry(path) == entry
    arr, mode = read_image(path)
    assert mode == entry["mode"] and str(arr.dtype) == entry["dtype"] and sha256(arr) == entry["sha256"]
    sizes = resize_sizes(arr.shape[1], arr.shape[0])
    for size in sizes:
        assert sha256(resize(arr, size, mode)) == entry["resized"][f"{size[0]}x{size[1]}"], size
    _assert_like_pillow_and_jax(path, sizes[:1])


def _route(lay):
    if lay.compression == 1:
        return "R"
    return "S" if lay.photometric != 6 or (lay.compression == 7 and lay.planar == 1) else "A"


def test_tiff_coding_corpus_is_complete():
    """The corpus covers each coding, YCbCr on each of Pillow's routes (R,
    S and A) and at each subsampling libtiff converts, each orientation on
    route A, tiles, both fill orders, planar YCbCr, JPEG without its
    subsampling tag, and old-style JPEG in both forms, grey and YCbCr at
    1x1, 2x1 and 2x2."""
    seen = set()
    for name in CODINGS:
        with open(os.path.join(CORPUS, name), "rb") as f:
            data = f.read()
        lay = image_containers.tiff_layout(name, data)
        seen |= {("compression", lay.compression), ("tiled", lay.tiles is not None), ("fill", lay.fill_order)}
        if lay.photometric == 6:
            route = _route(lay)
            seen |= {("ycbcr", route), ("ycbcr_planar", lay.planar)}
            if route == "A":
                seen |= {("orientation", lay.orientation), ("subsampling", tuple(lay.fields.get(530, (2, 2))))}
            if lay.compression == 7 and 530 not in lay.fields:
                seen.add(("jpeg_fixup", True))
        if lay.compression == 6:
            seen |= {("ojpeg_form", 513 in lay.fields), ("ojpeg_samples", len(lay.bits)),
                     ("ojpeg_subsampling", image_containers.ycbcr_subsampling(name, data, lay))}
    want = ([("compression", c) for c in (2, 3, 4, 6, 7, 32771, 32809, 34925, 50000)] + [("tiled", True), ("fill", 2)]
            + [("ycbcr", r) for r in "RSA"] + [("orientation", o) for o in range(1, 9)] + [("ycbcr_planar", 2)]
            + [("subsampling", s) for s in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))]
            + [("jpeg_fixup", True)] + [("ojpeg_form", f) for f in (False, True)]
            + [("ojpeg_samples", n) for n in (1, 3)] + [("ojpeg_subsampling", s) for s in ((1, 1), (2, 1), (2, 2))])
    assert not [w for w in want if w not in seen]


def _pil_tiff(img, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


def _random_file(coding, rng):
    """A seeded random file of ``coding``: Pillow's where Pillow writes it,
    the fixtures' where it does not; random size, strips or tiles and the
    coding's options."""
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 50))
    img = camera_like(h, w, 3, seed=int(rng.integers(1 << 16)))
    bw = camera_like(h, w, 1, seed=int(rng.integers(1 << 16)))[..., 0] > rng.integers(60, 200)
    rps = int(rng.integers(1, h + 1))
    if coding in ("group3", "group4", "tiff_ccitt"):
        info = {278: rps}
        if coding == "group3":
            info[292] = int(rng.choice([0, 1, 4, 5]))
            info[266] = int(rng.choice([1, 2]))
        return _pil_tiff(bw, compression=coding, tiffinfo=info)
    if coding == "group3_fixture":
        return fixtures.encode_tiff(bw[..., None], "group3", two_d=bool(rng.integers(2)), k=int(rng.integers(1, 5)),
                                    fill_bits=bool(rng.integers(2)), rows_per_strip=rps,
                                    photometric=int(rng.integers(2)))
    if coding == "group4_tiles":
        return fixtures.encode_tiff(bw[..., None], "group4", tile=(16 * int(rng.integers(1, 4)), 16))
    if coding == "jpeg":
        mode = str(rng.choice(["RGB", "YCbCr", "L"]))
        im = Image.fromarray(img).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression="jpeg", quality=int(rng.integers(30, 96)), tiffinfo={278: 8 * (rps // 8 + 1)})
        return buf.getvalue()
    if coding == "jpeg_fixture":
        ycc = bool(rng.integers(2))
        sub = tuple(int(v) for v in rng.choice([(1, 1), (2, 1), (2, 2)])) if ycc else None
        tile = (16 * int(rng.integers(1, 4)), 16 * int(rng.integers(1, 3))) if rng.integers(2) else None
        return fixtures.encode_tiff(img, "jpeg", photometric=6 if ycc else 2, ycbcr_subsampling=sub, tile=tile,
                                    rows_per_strip=None if tile else 8 * int(rng.integers(1, 5)),
                                    quality=int(rng.integers(40, 96)), tables=bool(rng.integers(2)))
    if coding in ("lzma", "zstd"):
        return _pil_tiff(img, compression=coding, tiffinfo={278: rps, 317: int(rng.choice([1, 2]))})
    if coding == "zstd_fixture":
        return fixtures.encode_tiff(img, "zstd", rows_per_strip=rps, predictor=int(rng.choice([1, 2])),
                                    literals=str(rng.choice(["huffman", "huffman1", "raw", "rle", "treeless"])),
                                    content_size=bool(rng.integers(2)), checksum=bool(rng.integers(2)),
                                    block_size=int(rng.choice([256, 4096, 65536])))
    if coding == "thunderscan":
        return fixtures.encode_tiff(img[..., :1] >> 4, "thunderscan", rows_per_strip=rps,
                                    seed=int(rng.integers(1 << 16)))
    if coding == "ojpeg":
        sub = tuple(int(v) for v in rng.choice([(1, 1), (2, 1), (2, 2), (4, 1)]))
        src = img if rng.integers(4) else img[..., :1]
        vs = sub[1] if src.shape[-1] == 3 else 1
        return tiff_encode.ojpeg_encode(src, str(rng.choice(tiff_encode.OJPEG_FORMS)), sub,
                                        rows_per_strip=8 * vs * int(rng.integers(1, 4)),
                                        quality=int(rng.integers(30, 96)), byteorder=str(rng.choice(["<", ">"])),
                                        fields={274: (3, [int(rng.integers(1, 9))])})
    if coding == "ycbcr":
        sub = tuple(int(v) for v in rng.choice(tiff_rgba_subsamplings()))
        codec = str(rng.choice(["lzw", "adobe_deflate", "packbits", "zstd", "lzma"]))
        tile = (16 * int(rng.integers(1, 3)), 16) if rng.integers(2) else None
        return fixtures.encode_tiff(img, codec, photometric=6, ycbcr_subsampling=sub, tile=tile,
                                    rows_per_strip=None if tile else rps, orientation=int(rng.integers(1, 9)))
    raise AssertionError(coding)


def tiff_rgba_subsamplings():
    from mlinerf_tpu_torch.utils import tiff_rgba

    return tiff_rgba.CONTIG_SUBSAMPLINGS


RANDOM_CODINGS = ["group3", "group3_fixture", "group4", "group4_tiles", "tiff_ccitt", "jpeg", "jpeg_fixture", "lzma",
                  "zstd", "zstd_fixture", "thunderscan", "ycbcr", "ojpeg"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("coding", RANDOM_CODINGS)
def test_random_codings_read_like_pillow_and_jax(coding, seed, tmp_path):
    rng = np.random.default_rng(1000 * RANDOM_CODINGS.index(coding) + seed)
    path = tmp_path / "r.tif"
    path.write_bytes(_random_file(coding, rng))
    arr = _assert_like_pillow_and_jax(str(path), [(int(rng.integers(1, 30)), int(rng.integers(1, 30)))])
    assert arr.size


def _cut_files():
    rgb = camera_like(20, 26, 3, seed=7)
    bw = camera_like(20, 26, 1, seed=8)[..., 0] > 127
    return {
        "group3_2d": _pil_tiff(bw, compression="group3", tiffinfo={292: 1}),
        "group4": _pil_tiff(bw, compression="group4"),
        "ccitt_rle": _pil_tiff(bw, compression="tiff_ccitt"),
        "jpeg_ycbcr": fixtures.encode_tiff(rgb, "jpeg", photometric=6),
        "lzma": _pil_tiff(rgb, compression="lzma"),
        "zstd": _pil_tiff(rgb, compression="zstd", tiffinfo={278: 7}),
        "thunderscan": fixtures.encode_tiff(rgb[..., :1] >> 4, "thunderscan"),
        "ycbcr_rgba_path": fixtures.encode_tiff(rgb, "lzw", photometric=6, rows_per_strip=8),
    }


@pytest.mark.parametrize("coding", sorted(_cut_files()))
def test_truncation_fails_where_pillow_fails(coding, tmp_path):
    """The file cut at points through its strips: the port reads it exactly
    when Pillow does (to the same array) and refuses it otherwise; libtiff
    fails every strip that ends past the end of the file."""
    data = _cut_files()[coding]
    lay = image_containers.tiff_layout(coding, data)
    start, end = min(lay.offsets), max(o + c for o, c in zip(lay.offsets, lay.byte_counts))
    path = tmp_path / "cut.tif"
    read = []
    for cut in np.linspace(start, len(data), 12).astype(int).tolist():
        path.write_bytes(data[:cut])
        want = _pillow_or_none(str(path))
        if want is None:
            with pytest.raises(ValueError):
                read_image(str(path))
        else:
            assert np.array_equal(read_image(str(path))[0], want), cut
        read.append(want is not None)
    assert not read[0] and read[-1] and end <= len(data)


def _flip_files():
    rgb = camera_like(14, 19, 3, seed=9)
    bw = Image.fromarray(camera_like(40, 64, 1, seed=10)[..., 0] > 127)
    buf = io.BytesIO()
    bw.save(buf, "TIFF", compression="tiff_raw_16")
    return {"zstd_pillow": _pil_tiff(rgb, compression="zstd"),
            "zstd_fixture": fixtures.encode_tiff(rgb, "zstd", content_size=True, literals="huffman1"),
            "thunderscan": fixtures.encode_tiff(rgb[..., :1] >> 4, "thunderscan", seed=3),
            "ccitt_rle": _pil_tiff(np.asarray(bw), compression="tiff_ccitt"), "ccitt_rlew": buf.getvalue(),
            "ycbcr_rgba_path_lzw": fixtures.encode_tiff(rgb, "lzw", photometric=6, rows_per_strip=6),
            "ycbcr_rgba_path_zstd": fixtures.encode_tiff(rgb, "zstd", photometric=6, ycbcr_subsampling=(4, 2),
                                                         rows_per_strip=4)}


@pytest.mark.parametrize("coding", sorted(_flip_files()))
def test_corruption_fails_where_pillow_fails(coding, tmp_path):
    """Bits flipped through the strips (codings whose corrupt data libtiff
    handles deterministically; on libtiff's RGBA path a strip it cannot
    decode gives what it decoded and zeros after it): the port fails
    exactly when Pillow fails and otherwise reads the same array."""
    data = _flip_files()[coding]
    lay = image_containers.tiff_layout(coding, data)
    rng = np.random.default_rng(sorted(_flip_files()).index(coding))
    path = tmp_path / "flip.tif"
    outcomes = set()
    spans = [(o, o + c) for o, c in zip(lay.offsets, lay.byte_counts)]
    for pos in (int(rng.integers(*spans[int(rng.integers(len(spans)))])) for _ in range(60)):
        d = bytearray(data)
        d[pos] ^= 1 << int(rng.integers(8))
        path.write_bytes(bytes(d))
        want = _pillow_or_none(str(path))
        if want is None:
            with pytest.raises(ValueError):
                read_image(str(path))
        else:
            assert np.array_equal(read_image(str(path))[0], want), pos
        outcomes.add(want is None)
    assert outcomes


def _tiff_with(fields, data=None):
    """An 8x8 RGB LZW TIFF (or ``data``) with ``fields`` (tag: value)
    overriding its directory's SHORT or LONG values."""
    data = bytearray(data or fixtures.encode_tiff(camera_like(8, 8, 3, seed=1), "lzw"))
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        tag, typ = struct.unpack_from("<HH", data, at)
        if tag in fields:
            struct.pack_into("<H", data, at + 8, fields[tag]) if typ == 3 else struct.pack_into("<I", data, at + 8,
                                                                                                  fields[tag])
    return bytes(data)


def _pil_ycbcr(rgb):
    """Pillow's own uncompressed YCbCr file: the strip ends the file, and
    Pillow's raw reader, which takes 4 bytes a pixel, runs out."""
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("YCbCr").save(buf, "TIFF")
    return buf.getvalue()


def _ycbcr_raw(extra):
    """An uncompressed 3-sample YCbCr file whose strip is followed by
    ``extra`` bytes: Pillow's raw reader takes 4 bytes a pixel (RGBX)."""
    h, w = 6, 7
    raw = np.random.default_rng(4).integers(0, 256, h * w * 3 + extra, dtype=np.uint8).tobytes()
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [6]), 277: (3, [3]),
              278: (4, [h])}
    return tiff_encode.tiff_file([raw], fields)


# (file, what Pillow does, the port's message): "raises" Pillow refuses it
# too; "tag" only the tag is patched (no real file of the coding exists
# here), so only the port's refusal is checked.
REFUSED = {
    # An LZW file called old-style JPEG: libtiff finds neither JPEG markers
    # nor its tables.
    "old_jpeg": (lambda: _tiff_with({259: 6}), "raises", "old-style JPEG: missing JPEG tables"),
    "ojpeg_no_dc_tables": (lambda: tiff_encode.ojpeg_encode(camera_like(16, 16, 3, seed=1), fields={520: None}),
                           "raises", r"missing JPEG tables \(no JPEGDCTables\)"),
    "ojpeg_strip_not_mcu_rows": (lambda: tiff_encode.ojpeg_encode(camera_like(32, 16, 3, seed=1), rows_per_strip=16,
                                                                  fields={278: (4, [12])}), "raises",
                                 "incompatible vertical subsampling and image strip length"),
    "ojpeg_cmyk_photometric": (lambda: tiff_encode.ojpeg_encode(camera_like(16, 16, 3, seed=1), fields={262: (3, [5])}),
                               "raises", r"old-style JPEG with 3 samples and photometric Separated \(CMYK\)"),
    "ojpeg_tiles": (lambda: _retagged(tiff_encode.ojpeg_encode(camera_like(16, 16, 3, seed=1), fields={
        322: (4, [16]), 323: (4, [16])}), {273: 324, 279: 325}), "tag", "old-style JPEG in tiles is not ported yet"),
    "webp_in_tiff": (lambda: _tiff_with({259: 50001}), "raises",
                     r"WebP compression \(50001\) is refused, as Pillow refuses it: .*without its WebP codec"),
    "sgilog": (lambda: _tiff_with({259: 34676}), "raises", r"SGILog compression \(34676\) is refused, as Pillow"),
    "sgilog24": (lambda: _tiff_with({259: 34677}), "raises", r"SGILog24 compression \(34677\) is refused, as Pillow"),
    "ycbcr_raw_pillow": (lambda: _pil_ycbcr(camera_like(9, 11, 3, seed=1)), "raises", "image file is truncated"),
    "ycbcr_rgba_14": (lambda: fixtures.encode_tiff(camera_like(8, 8, 3, seed=1), "lzw", photometric=6,
                                                   ycbcr_subsampling=(1, 4)), "raises", "no routine for YCbCr"),
    "jpeg_sampling_tag": (lambda: fixtures.encode_tiff(camera_like(16, 16, 3, seed=1), "jpeg", photometric=6,
                                                       fields={530: (3, [1, 1])}), "raises",
                          "improper JPEG sampling factors"),
    "jpeg_16_bits_tag": (lambda: _tiff_with({258: 16}, fixtures.encode_tiff(camera_like(8, 8, 1, seed=1), "jpeg")),
                         "raises", "JPEG data precision|unknown pixel mode"),
    "thunderscan_8_bits": (lambda: _tiff_with({258: 8}, fixtures.encode_tiff(camera_like(8, 8, 1, seed=1) >> 4,
                                                                             "thunderscan")), "raises",
                           "ThunderScan with 8-bit samples"),
    "group4_8_bits": (lambda: _tiff_with({258: 8}, fixtures.encode_tiff(np.ones((8, 8, 1), np.uint8), "group4")),
                      "raises", r"CCITT Group 4 with 8-bit samples"),
    "zstd_skippable_first": (lambda: fixtures.encode_tiff(camera_like(8, 8, 3, seed=1), "zstd", skippable="before"),
                             "raises", "not enough data in strip 0"),
    "zstd_bad_checksum": (lambda: _flip_last_strip_byte(fixtures.encode_tiff(camera_like(8, 8, 3, seed=1), "zstd",
                                                                             checksum=True)), "raises",
                          "checksum does not match"),
}


def _retagged(data, renames):
    """A little-endian TIFF with the tags of its first directory renamed
    ({old: new}): its strips become tiles."""
    data = bytearray(data)
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        struct.pack_into("<H", data, at, renames.get(struct.unpack_from("<H", data, at)[0],
                                                     struct.unpack_from("<H", data, at)[0]))
    return bytes(data)


def _flip_last_strip_byte(data):
    lay = image_containers.tiff_layout("x", data)
    d = bytearray(data)
    d[lay.offsets[-1] + lay.byte_counts[-1] - 1] ^= 0x40
    return bytes(d)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_coding(case, tmp_path):
    """Each refusal is a ValueError that names the coding and says whether
    Pillow refuses it here (and why) or the port has not ported it yet."""
    make, pillow, message = REFUSED[case]
    path = tmp_path / f"{case}.tif"
    path.write_bytes(make())
    if pillow == "raises":
        assert _pillow_or_none(str(path)) is None
    with pytest.raises(ValueError, match=message):
        read_image(str(path))


def test_ycbcr_raw_reads_as_rgbx_like_pillow(tmp_path):
    """Route R: an uncompressed YCbCr file goes through Pillow's raw reader
    as RGBX (4 bytes a pixel, no conversion); with the bytes there, Pillow
    reads it, and so does the port."""
    path = tmp_path / "ycbcr_raw.tif"
    path.write_bytes(_ycbcr_raw(6 * 7))
    got = _assert_like_pillow_and_jax(str(path), [(4, 3)])
    assert got.shape == (6, 7, 3)


ENCODER_CASES = {
    "jpeg_ycbcr420": (dict(compression="jpeg", photometric=6), 6.0),
    "jpeg_rgb_tiles": (dict(compression="jpeg", tile=(32, 16)), 6.0),
    "ycbcr22_lzw": (dict(compression="lzw", photometric=6, ycbcr_subsampling=(2, 2)), 6.0),
    "ycbcr42_deflate": (dict(compression="deflate", photometric=6, ycbcr_subsampling=(4, 2)), 8.0),
    "zstd": (dict(compression="zstd", predictor=2), 0),
    "zstd_every_option": (dict(compression="zstd", content_size=True, checksum=True, literals="huffman1"), 0),
    "lzma": (dict(compression="lzma"), 0),
    "group3_2d": (dict(compression="group3", two_d=True, fill_bits=True), 0),
    "group4": (dict(compression="group4"), 0),
    "ccitt_rle": (dict(compression="ccitt_rle"), 0),
    "thunderscan": (dict(compression="thunderscan"), 0),
    "ojpeg_tables": (dict(compression="ojpeg", form="tables"), 8.0),
    "ojpeg_interchange": (dict(compression="ojpeg", form="interchange", ycbcr_subsampling=(2, 1)), 8.0),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_fixture_encoders_read_back_by_pillow(case, tmp_path):
    """Each encoder's file reads back through Pillow as its source: exactly
    for the lossless codings (1-bit as set or clear, 4-bit as v * 17), within
    a mean error for JPEG and subsampled YCbCr; and the port reads it as
    Pillow does."""
    kw, tol = ENCODER_CASES[case]
    rgb = camera_like(29, 37, 3, seed=11)
    c = kw["compression"]
    src = (rgb[..., :1] > 120).astype(np.uint8) if c in ("group3", "group4", "ccitt_rle") else (
        rgb[..., :1] >> 4 if c == "thunderscan" else rgb)
    path = tmp_path / f"{case}.tif"
    if c == "ojpeg":
        path.write_bytes(tiff_encode.ojpeg_encode(src, **{k: v for k, v in kw.items() if k != "compression"}))
    else:
        path.write_bytes(fixtures.encode_tiff(src, **kw))
    got, mode = _pillow(str(path))
    want = (src.astype(bool) if mode == "1" else src * 17 if c == "thunderscan" else src)
    if tol:
        assert got.shape == want.shape and np.abs(got.astype(np.int64) - want).mean() < tol
    else:
        assert got.shape == want.shape and np.array_equal(got, want.astype(got.dtype))
    _assert_like_pillow_and_jax(str(path), [])


@pytest.mark.parametrize("proc", [1, 14])
def test_ojpeg_tables_form_is_baseline_whatever_jpegproc_says(proc, tmp_path):
    """libtiff builds a baseline frame (SOF0) from the tables whatever
    JPEGProc says, lossless 14 included: Pillow reads both files alike, and
    so does the port."""
    path = tmp_path / f"proc{proc}.tif"
    path.write_bytes(tiff_encode.ojpeg_encode(camera_like(24, 40, 3, seed=2), "tables", rows_per_strip=16,
                                              fields={512: (3, [proc])}))
    _assert_like_pillow_and_jax(str(path), [(13, 7)])


@pytest.mark.parametrize("restart", ["none", "wrong"])
def test_ojpeg_strips_take_libtiffs_restart_interval(restart, tmp_path):
    """Old-style JPEG strips joined with no JPEGRestartInterval, or with one
    that is not a strip's MCUs: libtiff's OJPEGReadHeaderInfo makes each
    strip a restart interval whatever the field says, puts an RST marker
    between the strips and libjpeg reads every strip; Pillow reads the
    file, and so does the port."""
    path = tmp_path / f"{restart}.tif"
    field = {515: None} if restart == "none" else {515: (3, [1])}
    path.write_bytes(tiff_encode.ojpeg_encode(camera_like(48, 64, 3, seed=4), "tables", (2, 2), rows_per_strip=16,
                                              fields=field))
    _assert_like_pillow_and_jax(str(path), [(13, 7)])
