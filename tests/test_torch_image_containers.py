"""The port's TIFF and BMP reader (mlinerf_tpu_torch/utils/image_containers.py,
with csrc/container_decode.cpp) against Pillow and the JAX package's
``load_image``, bitwise (tolerance 0), with and without ``size``: every
TIFF and BMP file of the committed corpus (the manifest's ``containers``),
seeded random files over mode x compression x predictor x strips/tiles x
byte order (TIFF) and depth x compression (BMP), written by Pillow where
Pillow writes the coding and by the fixtures' writers where it does not;
each of Pillow's unpackers the reader mirrors, against Pillow's own on
random bytes; the resize of the modes TIFF adds ("I", "F", "I;16B", "PA",
"LAB", "CMYK"); the fixture writers read back by Pillow; every file Pillow
refuses refused by a ValueError that names the feature; and the files of
the libtiff codecs ported since (JPEG, CCITT, LZMA, ZSTD, YCbCr) read as
Pillow reads them (tests/test_torch_tiff_codings.py holds those codings in
full)."""

import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import CORPUS, MANIFEST, camera_like, resize_sizes, sha256
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.ops import cuda_build
from mlinerf_tpu_torch.utils import image_containers
from mlinerf_tpu_torch.utils.image_io import load_image, read_image, resize

with open(MANIFEST) as _f:
    _MANIFEST = json.load(_f)
CONTAINERS = _MANIFEST["containers"]


def _pillow(path):
    with Image.open(path) as im:
        arr = np.asarray(im)
        return arr.reshape(arr.shape + (1,) * (3 - arr.ndim)), im.mode


def _assert_like_pillow_and_jax(path, sizes):
    """The port's array, dtype (byte order included) and mode equal
    Pillow's; load_image equals the JAX package's at each size."""
    got, mode = read_image(path)
    want, want_mode = _pillow(path)
    assert mode == want_mode and got.dtype == want.dtype and got.shape == want.shape, (mode, want_mode, got.dtype)
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")
    for size in [None, *sizes]:
        a, b = load_image(path, size), jax_load_image(path, size)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (size, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=True), (path, size)


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_container_corpus_reads_like_jax_bitwise(name):
    path = os.path.join(CORPUS, name)
    entry = CONTAINERS[name]
    arr, mode = read_image(path)
    assert mode == entry["mode"] and str(arr.dtype) == entry["dtype"], (mode, arr.dtype, entry["dtype"])
    assert sha256(arr) == entry["sha256"]
    assert list(arr.shape) == entry["shape"] + ([1] if len(entry["shape"]) == 2 else [])
    sizes = resize_sizes(arr.shape[1], arr.shape[0])
    for size in sizes:
        assert sha256(resize(arr, size, mode)) == entry["resized"][f"{size[0]}x{size[1]}"], size
    _assert_like_pillow_and_jax(path, sizes)


def test_container_corpus_is_small_and_complete():
    """The whole corpus (JPEG, PNG, TIFF and BMP) stays under 300,000
    bytes; the TIFF and BMP files cover every mode, compression,
    predictor and layout the reader decodes."""
    names = [*_MANIFEST["files"], *CONTAINERS]
    assert sum(os.path.getsize(os.path.join(CORPUS, n)) for n in names) < 300_000
    assert {e["mode"] for e in CONTAINERS.values()} == {"1", "L", "LA", "P", "PA", "I;16", "I;16B", "I", "F", "RGB",
                                                       "RGBA", "CMYK", "LAB"}
    seen = set()
    for name in CONTAINERS:
        with open(os.path.join(CORPUS, name), "rb") as f:
            data = f.read()
        if name.endswith(".tif"):
            lay = image_containers.tiff_layout(name, data)
            seen |= {("compression", lay.compression), ("predictor", lay.predictor), ("planar", lay.planar),
                     ("tiled", lay.tiles is not None), ("order", lay.order), ("orientation", lay.orientation > 4),
                     ("fill", lay.fill_order), ("bigtiff", data[2] == 43)}
        else:
            header, bits, compression = struct.unpack_from("<IHH", data, 14)[0], None, None
            bits = struct.unpack_from("<H", data, 24 if header == 12 else 28)[0]
            compression = 0 if header == 12 else struct.unpack_from("<I", data, 30)[0]
            seen |= {("bmp_header", header), ("bmp_bits", bits), ("bmp_compression", compression)}
    for want in ([("compression", c) for c in (1, 5, 8, 32773, 32946)] + [("predictor", p) for p in (1, 2, 3)]
                 + [("planar", 2), ("tiled", True), ("order", ">"), ("orientation", True), ("fill", 2),
                    ("bigtiff", True)] + [("bmp_header", h) for h in (12, 40, 56, 124)]
                 + [("bmp_bits", b) for b in (1, 4, 8, 16, 24, 32)] + [("bmp_compression", c) for c in (0, 1, 2, 3)]):
        assert want in seen, want


# Random TIFFs: each mode with the dtype, samples and photometric it is
# written from.
TIFF_MODES = {"1": (np.uint8, 1), "L": (np.uint8, 1), "LA": (np.uint8, 2), "P": (np.uint8, 1),
              "I;16": (np.uint16, 1), "I": (np.int32, 1), "F": (np.float32, 1), "RGB": (np.uint8, 3),
              "RGBA": (np.uint8, 4), "CMYK": (np.uint8, 4)}
COMPRESSIONS = {"none": "raw", "lzw": "tiff_lzw", "adobe_deflate": "tiff_adobe_deflate", "packbits": "packbits"}


def _random_samples(rng, mode, h, w):
    dtype, c = TIFF_MODES[mode]
    if mode == "F":
        return rng.normal(0, 300, (h, w, 1)).astype(np.float32)
    if mode == "I":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, (h, w, 1), dtype=np.int64).astype(np.int32)
    if mode == "1":
        return rng.integers(0, 2, (h, w, 1), dtype=np.uint8)
    img = camera_like(h, w, c, seed=int(rng.integers(1 << 16))).astype(dtype)
    return img * 257 + rng.integers(0, 257, img.shape).astype(np.uint16) if dtype == np.uint16 else img


def _pillow_tiff(img, mode, compression, predictor):
    """What Pillow writes of ``img`` in ``mode`` (strips, little-endian)."""
    if mode == "1":
        im = Image.fromarray(img[..., 0] > 0)
    elif mode in ("L", "P", "I;16", "I", "F"):
        im = Image.fromarray(img[..., 0])
        if mode == "P":
            im = im.convert("P")
    else:
        im = Image.fromarray(img, mode)
    kw = {} if compression == "none" else {"compression": COMPRESSIONS[compression]}
    if predictor == 2:
        kw["tiffinfo"] = {317: 2}
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _fixture_tiff(img, mode, compression, predictor, tiled, order):
    colormap = np.random.default_rng(0).integers(0, 65536, (3, 256)) if mode == "P" else None
    extra = {"LA": (2,), "RGBA": (2,)}.get(mode, ())
    photometric = {"CMYK": 5, "P": 3}.get(mode)
    return fixtures.encode_tiff(img, compression, order, predictor, tile=(16, 16) if tiled else None,
                                rows_per_strip=None if tiled else 5, photometric=photometric, extra_samples=extra,
                                bits=1 if mode == "1" else None, colormap=colormap)


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
@pytest.mark.parametrize("mode", sorted(TIFF_MODES))
def test_random_tiffs_read_like_jax_bitwise(mode, compression, predictor, tiled, order, tmp_path):
    """Seeded random files, odd sizes that leave edge tiles and a short
    last strip; little-endian strips by Pillow's writer (libtiff's for a
    compression), the rest by the fixtures'. A file Pillow refuses (libtiff
    refuses predictor 2 on 1-bit samples) the port refuses too."""
    rng = np.random.default_rng([sorted(TIFF_MODES).index(mode), sorted(COMPRESSIONS).index(compression), predictor,
                                 tiled, order == ">"])
    for i, (h, w) in enumerate(((1, 1), (19, 37))):
        img = _random_samples(rng, mode, h, w)
        by_pillow = not tiled and order == "<" and not (mode == "1" and predictor == 2)  # Pillow writes neither
        data = (_pillow_tiff(img, mode, compression, predictor) if by_pillow
                else _fixture_tiff(img, mode, compression, predictor, tiled, order))
        path = str(tmp_path / f"r{i}.tif")
        with open(path, "wb") as f:
            f.write(data)
        try:
            _pillow(path)
        except Exception:
            with pytest.raises(ValueError, match="predictor"):
                read_image(path)
            continue
        _assert_like_pillow_and_jax(path, [(w + 3, 2 * h + 1), (max(1, w // 2), max(1, (2 * h) // 3))])


BMP_CASES = {  # name: (bits, compression, writer): Pillow's where it writes the coding
    "1_none": (1, "none", "pillow"), "4_none": (4, "none", "fixtures"), "8_none": (8, "none", "pillow"),
    "4_rle4": (4, "rle4", "fixtures"), "8_rle8": (8, "rle8", "fixtures"),
    "16_bitfields_565": (16, "bitfields", "fixtures"), "16_bitfields_555": (16, "bitfields", "fixtures"), "24_none": (24, "none", "pillow"),
    "32_none": (32, "none", "pillow"), "32_bitfields_alpha": (32, "bitfields", "fixtures"),
}


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_random_bmps_read_like_jax_bitwise(case, tmp_path):
    bits, compression, writer = BMP_CASES[case]
    rng = np.random.default_rng(sorted(BMP_CASES).index(case))
    for i, (h, w) in enumerate(((1, 1), (17, 29), (8, 33))):
        top_down = bool(i == 2 and writer == "fixtures")
        if writer == "pillow":
            img = camera_like(h, w, 4, seed=i)
            im = {1: lambda: Image.fromarray(img[..., 0] > 127), 8: lambda: Image.fromarray(img[..., 0], "L"),
                  24: lambda: Image.fromarray(img[..., :3]), 32: lambda: Image.fromarray(img, "RGBA")}[bits]()
            buf = io.BytesIO()
            im.save(buf, "BMP")
            data = buf.getvalue()
        elif bits <= 8:
            n = 1 << bits
            idx = rng.integers(0, n, (h, w))
            idx[:, : w // 2] = idx[:, :1]  # runs for RLE
            data = fixtures.encode_bmp(idx, bits, compression, palette=rng.integers(0, 256, (n, 3)), top_down=top_down)
        else:
            masks = {"16_bitfields_565": (0xF800, 0x7E0, 0x1F), "16_bitfields_555": (0x7C00, 0x3E0, 0x1F, 0),
                     "32_bitfields_alpha": (0xFF0000, 0xFF00, 0xFF, 0xFF000000)}[case]
            img = rng.integers(0, 256, (h, w, len(masks)), dtype=np.uint8)
            data = fixtures.encode_bmp(img, bits, "bitfields", header=40 if len(masks) == 3 else 124,
                                       top_down=top_down, masks=masks)
        path = str(tmp_path / f"r{i}.bmp")
        with open(path, "wb") as f:
            f.write(data)
        _assert_like_pillow_and_jax(path, [(w + 3, 2 * h + 1), (max(1, w // 2), max(1, (2 * h) // 3))])


def _unpacker_pairs():
    pairs = set(image_containers.OPEN_INFO.values())
    pairs |= {(m, "I;16N") for m, r in pairs if r == "I;16"}
    pairs |= {(m, r[:-1] + "N") for m, r in pairs if r.endswith((";16B", ";16L"))}
    pairs |= {("RGB", r) for r in ("BGR;15", "BGR;16", "BGR", "BGRX", "XBGR", "BGXR")}
    pairs |= {("RGBA", r) for r in ("ABGR", "RGBA", "BGRA", "BGAR")}
    pairs |= {("P", "P;1"), ("P", "P;4"), ("1", "1"), ("L", "L"), ("I", "I"), ("F", "F"), ("I;16", "I;16R")}
    return sorted(pairs)


@pytest.mark.parametrize("mode,raw", _unpacker_pairs(), ids=lambda v: str(v))
def test_unpackers_match_pillow(mode, raw):
    """Each of Pillow's unpackers the reader uses, on random bytes (alpha
    0 and 255 among them), into Pillow's image of ``mode``; a raw mode in
    OPEN_INFO that Pillow has no unpacker for is refused by both."""
    rng = np.random.default_rng(len(mode) * 100 + len(raw))
    count, rows = 67, 3
    data = rng.integers(0, 256, (rows, 8 * count), dtype=np.uint8)
    data[:, 3::8] = np.where(rng.random((rows, count)) < 0.2, 0, data[:, 3::8])
    data[:, 7::8] = np.where(rng.random((rows, count)) < 0.2, 255, data[:, 7::8])
    bits = image_containers.raw_bits(raw)
    need = -(-count * bits // 8)
    try:
        want = [np.asarray(Image.frombytes(mode, (count, 1), data[r, :need].tobytes(), "raw", raw))
                for r in range(rows)]
    except ValueError:
        with pytest.raises(ValueError, match="no unpacker"):
            image_containers.unpack(mode, raw, data[:, :need], count)
        return
    got = image_containers._as_array(mode, image_containers.unpack(mode, raw, data[:, :need], count))
    for r in range(rows):
        w = want[r].reshape(got[r:r + 1].shape)
        assert got.dtype == w.dtype and np.array_equal(got[r:r + 1], w, equal_nan=True), (mode, raw, r)


@pytest.mark.parametrize("mode", ["I", "F", "I;16B", "PA", "LAB", "CMYK"])
def test_new_modes_resize_like_pillow(mode):
    """Pillow's resize of the modes TIFF brings: "I" and "F" in its 32-bit
    passes (values past int32's range, inf and nan among the inputs),
    "I;16B" in its 16-bit pass (which reads the bytes little-endian), "PA"
    and "CMYK" as plain 8-bit channels, "LAB" with a and b signed."""
    rng = np.random.default_rng(["I", "F", "I;16B", "PA", "LAB", "CMYK"].index(mode))
    h, w = 13, 19
    if mode == "I":
        arr = rng.integers(-2 ** 31, 2 ** 31 - 1, (h, w), dtype=np.int64).astype(np.int32)
        arr[::3] = 2 ** 31 - 1
        im = Image.fromarray(arr)
    elif mode == "F":
        arr = rng.normal(0, 1e3, (h, w)).astype(np.float32)
        arr[1, 2], arr[4, 4], arr[6, 0], arr[0, :] = np.inf, np.nan, -0.0, 3e38
        im = Image.fromarray(arr)
    else:
        nbytes = {"I;16B": 2, "PA": 2, "LAB": 3, "CMYK": 4}[mode]
        im = Image.frombytes(mode, (w, h), rng.integers(0, 256, h * w * nbytes, dtype=np.uint8).tobytes())
    src = np.asarray(im)
    src = src.reshape(src.shape + (1,) * (3 - src.ndim))
    for size in ((7, 5), (w + 11, 2 * h + 3), (w, 4), (3, h)):
        want = np.asarray(im.resize(size))
        got = resize(src, size, mode)
        got = np.ascontiguousarray(got.reshape(want.shape))
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8)), (mode, size)


FIXTURE_TIFFS = {
    "rgb8_lzw_pred2": dict(compression="lzw", predictor=2),
    "rgb8_deflate_tiles_mm": dict(compression="adobe_deflate", tile=(16, 32), byteorder=">"),
    "rgba16_lzw_pred2_mm": dict(compression="lzw", predictor=2, byteorder=">", extra_samples=(2,), wide=True),
    "rgb16_packbits_tiles": dict(compression="packbits", tile=(32, 16), wide=True),
    "rgb8_none_planar": dict(planar=2),
    "rgb8_deflate_bigtiff": dict(compression="deflate", bigtiff=True),
}


@pytest.mark.parametrize("case", sorted(FIXTURE_TIFFS))
def test_fixture_tiff_round_trip(case, tmp_path):
    """Pillow reads the fixtures' TIFF back to the samples written (the
    16-bit ones to their high bytes, as Pillow's RGB(A) from 16 bits); the
    port reads it as Pillow does."""
    kw = dict(FIXTURE_TIFFS[case])
    wide = kw.pop("wide", False)
    c = 4 if kw.get("extra_samples") else 3
    img = camera_like(37, 53, c, seed=3)
    src = img.astype(np.uint16) * 257 if wide else img
    path = str(tmp_path / f"{case}.tif")
    with open(path, "wb") as f:
        f.write(fixtures.encode_tiff(src, **kw))
    want, mode = _pillow(path)
    assert mode == ("RGBA" if c == 4 else "RGB") and np.array_equal(want, img)
    _assert_like_pillow_and_jax(path, [(20, 14)])


FIXTURE_BMPS = {
    "rgb24": dict(), "rgb24_topdown_v5": dict(header=124, top_down=True), "rgbx32": dict(bits=32),
    "bgra_bitfields": dict(bits=32, compression="bitfields", header=124, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "p8_os2": dict(bits=8, header=12), "p8_rle8": dict(bits=8, compression="rle8"),
    "p4_rle4_even": dict(bits=4, compression="rle4"), "p1": dict(bits=1),
}


@pytest.mark.parametrize("case", sorted(FIXTURE_BMPS))
def test_fixture_bmp_round_trip(case, tmp_path):
    """Pillow reads the fixtures' BMP back to what was written (indices for
    a palette; RGB, or RGBA through alpha bitfields); the port reads it as
    Pillow does."""
    kw = dict(FIXTURE_BMPS[case])
    bits = kw.get("bits", 24)
    rng = np.random.default_rng(sorted(FIXTURE_BMPS).index(case))
    if bits <= 8:
        img = rng.integers(0, 1 << bits, (21, 34))
        img[:, 10:20] = 1  # a run (RLE4 keeps pixels of even-length absolute runs)
        kw["palette"] = rng.integers(0, 256, (1 << bits, 3))
        expect = img[..., None]
    else:
        img = camera_like(21, 34, 4 if kw.get("masks") or bits == 32 else 3, seed=4)
        expect = img if kw.get("masks") else img[..., :3]
    path = str(tmp_path / f"{case}.bmp")
    with open(path, "wb") as f:
        f.write(fixtures.encode_bmp(img, **kw))
    want, mode = _pillow(path)
    if case == "p4_rle4_even":
        assert mode == "P" and want.shape == expect.shape
    else:
        assert np.array_equal(want, expect), case
    _assert_like_pillow_and_jax(path, [(20, 14)])


def _bmp(bits=24, compression=0, header=40, colors=0, masks=None, data=b""):
    info = struct.pack("<IiiHHIIiiII", header, 4, 2, 1, bits, compression, len(data), 0, 0, colors, 0)
    if header > 40:
        info += struct.pack("<4I", *(masks or (0, 0, 0, 0))) + bytes(header - 56)
    elif masks:
        info += struct.pack("<3I", *masks[:3])
    off = 14 + len(info)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + data


def _tiff_with(fields):
    """A 4x4 RGB LZW TIFF with predictor 2, ``fields`` (tag: value)
    overriding its directory's."""
    data = bytearray(fixtures.encode_tiff(camera_like(4, 4, 3, seed=1), "lzw", predictor=2))
    ifd = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, ifd)[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag = struct.unpack_from("<H", data, at)[0]
        if tag in fields:
            struct.pack_into("<HHII", data, at, tag, 3, 1, fields[tag])
    return bytes(data)


def _pillow_tiff_coded(compression, mode="RGB"):
    im = Image.fromarray(camera_like(8, 8, 3, seed=2))
    im = im.convert("1") if mode == "1" else im
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _ycbcr():
    return fixtures.encode_tiff(camera_like(8, 8, 3, seed=2), "lzw", photometric=6)


# (file, what Pillow does, the port's message). "reads": Pillow decodes it
# through one of libtiff's codecs, which the port now has too (no message:
# the port reads it as Pillow does); "raises": Pillow refuses it too.
REFUSED = {
    "bmp_jpeg_inside": (lambda: _bmp(24, 4), "raises", r"BMP: unsupported compression \(JPEG\)"),
    "bmp_png_inside": (lambda: _bmp(24, 5), "raises", r"BMP: unsupported compression \(PNG\)"),
    "bmp_odd_masks": (lambda: _bmp(32, 3, masks=(0xF00, 0xF0, 0xF, 0)), "raises", "unsupported bitfields layout"),
    "bmp_2_bit": (lambda: _bmp(2), "raises", r"unsupported pixel depth \(2 bits\)"),
    "bmp_header_20": (lambda: _bmp(24, header=20), "raises", r"unsupported header type \(20 bytes\)"),
    "bmp_palette_too_big": (lambda: _bmp(8, colors=70000), "raises", r"unsupported palette size \(70000"),
    "bmp_truncated": (lambda: _bmp(24, data=bytes(10)), "raises", "truncated"),
    "bmp_rle_short": (lambda: _bmp(8, 1, data=b"\x02\x05\x00\x01"), "raises", "not enough RLE image data"),
    "tiff_unknown_mode": (lambda: _tiff_with({262: 9}), "raises", "unknown pixel mode"),
    "tiff_predictor_1bit": (lambda: fixtures.encode_tiff(np.ones((4, 9, 1), np.uint8), "lzw", predictor=2, bits=1),
                            "raises", "horizontal differencing predictor with 1-bit samples"),
    "tiff_fp_predictor_ints": (lambda: _tiff_with({317: 3}), "raises", "floating point predictor"),
    "tiff_truncated_strip": (lambda: fixtures.encode_tiff(camera_like(30, 30, 3, seed=1), "none")[:600], "raises",
                             "truncated"),
    "tiff_lzw_cut_short": (lambda: _tiff_with({279: 9}), "raises", "not enough data in strip 0"),
    "tiff_no_colormap": (lambda: _tiff_with({262: 3, 277: 1}), "raises", "unknown pixel mode|colour map"),
    "tiff_planar_rgbx_strips": (lambda: fixtures.encode_tiff(camera_like(5, 5, 4, seed=1), "lzw", planar=2,
                                                             extra_samples=(0,)), "raises", "planar configuration 2"),
    "tiff_bad_version_lzw": (lambda: b"II\x00\x2a" + fixtures.encode_tiff(camera_like(4, 4, 3, seed=1), "lzw")[4:],
                             "raises", "bad version number"),
    "tiff_jpeg": (lambda: _pillow_tiff_coded("jpeg"), "reads", None),
    "tiff_ccitt_rle": (lambda: _pillow_tiff_coded("tiff_ccitt", "1"), "reads", None),
    "tiff_group3": (lambda: _pillow_tiff_coded("group3", "1"), "reads", None),
    "tiff_group4": (lambda: _pillow_tiff_coded("group4", "1"), "reads", None),
    "tiff_lzma": (lambda: _pillow_tiff_coded("lzma"), "reads", None),
    "tiff_zstd": (lambda: _pillow_tiff_coded("zstd"), "reads", None),
    "tiff_ycbcr": (_ycbcr, "reads", None),
    "tiff_webp": (lambda: _tiff_with({259: 50001}), None, r"WebP compression \(50001\)"),
    "tiff_sgilog": (lambda: _tiff_with({259: 34676}), None, r"SGILog compression \(34676\)"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_feature(case, tmp_path):
    """The port raises ValueError naming what it refuses, what Pillow
    refuses too (Pillow None: its libtiff has no such encoder to make a real
    file, so only the port's refusal of the tag is checked); a file of a
    libtiff codec the port now has ("reads") it reads as Pillow does."""
    make, pillow, message = REFUSED[case]
    path = tmp_path / (case + (".bmp" if case.startswith("bmp") else ".tif"))
    path.write_bytes(make())
    if pillow == "raises":
        with pytest.raises(Exception):
            with Image.open(path) as im:
                im.load()
    elif pillow == "reads":
        _assert_like_pillow_and_jax(str(path), [(5, 11)])
        return
    with pytest.raises(ValueError, match=message):
        load_image(str(path))


def _lzw_old_style(data):
    """LZW as TIFF writers before TIFF 5.0 coded it, which libtiff still
    reads: codes least significant bit first, widened only once the next
    code needs the bit (no early change)."""
    codes, widths, table, nbits, free, prefix = [256], [9], {}, 9, 258, None
    for b in data:
        if prefix is None:
            prefix = b
        elif (prefix << 8 | b) in table:
            prefix = table[prefix << 8 | b]
        else:
            codes.append(prefix)
            widths.append(nbits)
            table[prefix << 8 | b], free, prefix = free, free + 1, b
            if free == 4093:
                codes.append(256)
                widths.append(nbits)
                table, nbits, free = {}, 9, 258
            elif free > 1 << nbits:
                nbits += 1
    codes.append(prefix)
    widths.append(nbits)
    nbits += free + 1 > 1 << nbits
    codes.append(257)
    widths.append(nbits)
    bits = [(c >> i) & 1 for c, w in zip(codes, widths) for i in range(w)]
    bits += [0] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8).reshape(-1, 8)[:, ::-1]).tobytes()


@pytest.mark.parametrize("h,w", [(5, 7), (90, 120)], ids=["small", "table_resets"])
def test_old_style_lzw_reads_like_pillow(h, w, tmp_path, monkeypatch):
    """A strip in the old LSB-first LZW coding (the data begins 0x00 and an
    odd byte), long enough in one case for the table to fill and reset."""
    img = np.random.default_rng(h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    monkeypatch.setattr(fixtures, "_lzw", _lzw_old_style)
    data = fixtures.encode_tiff(img, "lzw", rows_per_strip=h)
    path = tmp_path / "old.tif"
    path.write_bytes(data)
    assert _pillow(str(path))[0].shape == img.shape and np.array_equal(_pillow(str(path))[0], img)
    _assert_like_pillow_and_jax(str(path), [(w // 2, h + 3)])


def test_container_library_builds_into_build(tmp_path):
    path = tmp_path / "probe.tif"
    path.write_bytes(fixtures.encode_tiff(camera_like(8, 8, 3, seed=0), "lzw"))
    read_image(str(path))
    lib = cuda_build.library_path("container_decode")
    assert lib.parent == cuda_build.BUILD_DIR and lib.exists()
    assert "container_decode" not in cuda_build.kernel_names()  # a host library, not a CUDA kernel


def test_failed_container_build_raises(tmp_path, monkeypatch):
    """No Python decoder stands behind the library: a failed build raises."""
    path = tmp_path / "a.tif"
    path.write_bytes(fixtures.encode_tiff(camera_like(8, 8, 3, seed=0), "lzw"))
    monkeypatch.setattr(image_containers, "_LIB", None)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "_is_stale", lambda name: True)
    monkeypatch.setattr(cuda_build, "_compiler_command", lambda name, out: ["false"])
    with pytest.raises(RuntimeError, match="build failed for container_decode"):
        read_image(str(path))
