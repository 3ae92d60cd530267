"""The port's image IO (mlinerf_tpu_torch/utils/image_io.py) against Pillow
and the JAX package's ``load_image``: PNGs with each of the five row filters
in grey, RGB and RGBA, decoded bit-equal to Pillow; the resize to Pillow's
bicubic definition, RGB and RGBA, at ReNe's 1440x1080 -> 360x270 and at a
non-integer ratio (tolerance 1/255; it reaches bit-equality here); the
native row-filter library built into ``build/``; and the files it refuses.
The other bit depths, colour types, interlace and JPEG are held in
tests/test_torch_image_decode.py."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.ops import cuda_build
from mlinerf_tpu_torch.utils import image_io
from mlinerf_tpu_torch.utils.image_io import load_image, read_png, resize, save_png

MODES = {1: "L", 3: "RGB", 4: "RGBA"}
FILTERS = ["none", "sub", "up", "average", "paeth"]


def _camera_like(h, w, c, seed=0):
    """Smooth shading and edges with sensor noise, and for RGBA an alpha
    with opaque, clear and partial regions."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 110 * np.sin(x / (11 + 4 * k) + y / (17 + 3 * k) + k) for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 6, (h, w, c)), 0, 255).astype(np.uint8)
    if c == 4:
        img[..., 3] = np.clip(255 * (np.sin(x / 9.0) + np.cos(y / 7.0)), 0, 255).astype(np.uint8)
    return img


def _pil(img):
    return Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img, MODES[img.shape[-1]])


def _pil_array(path):
    arr = np.asarray(Image.open(path))
    return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("channels", [1, 3, 4], ids=lambda c: MODES[c])
@pytest.mark.parametrize("filt", FILTERS + ["camera_mix"])
def test_each_row_filter_decodes_bit_equal_to_pil(filt, channels, tmp_path):
    img = _camera_like(41, 57, channels, seed=channels)
    if filt == "camera_mix":
        from mlinerf_tpu_torch.data.fixtures import camera_filters

        filters = camera_filters(41, np.random.default_rng(0))
    else:
        filters = [FILTERS.index(filt)] * 41
    path = str(tmp_path / "f.png")
    save_png(path, img, filters=filters)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, _pil_array(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(load_image(path), jax_load_image(path))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=lambda c: MODES[c])
def test_reads_files_pillow_wrote(channels, tmp_path):
    """Pillow's own encoder picks filters per row (optimize=True as well)."""
    img = _camera_like(64, 48, channels, seed=7)
    for optimize in (False, True):
        path = str(tmp_path / f"pil_{optimize}.png")
        _pil(img).save(path, optimize=optimize)
        np.testing.assert_array_equal(read_png(path), img)
        np.testing.assert_array_equal(load_image(path), jax_load_image(path))


@pytest.mark.parametrize("channels", [3, 4], ids=lambda c: MODES[c])
@pytest.mark.parametrize("raw, size", [((1440, 1080), (360, 270)), ((1440, 1080), (517, 389)), ((97, 61), (41, 29)),
                                       ((40, 30), (64, 45))], ids=["rene_4x", "non_integer", "small_odd", "upscale"])
def test_resize_matches_pillow(raw, size, channels, tmp_path):
    """load_image(path, size) against the JAX package's (Pillow's
    Image.resize): within 1/255 everywhere; the share of values that differ
    is 0 with this Pillow."""
    img = _camera_like(raw[1], raw[0], channels, seed=11)
    path = str(tmp_path / "raw.png")
    _pil(img).save(path)
    got, want = load_image(path, size), jax_load_image(path, size)
    assert got.shape == want.shape == (size[1], size[0], channels)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 / 255 + 1e-7
    assert np.mean(diff > 0) == 0.0
    np.testing.assert_array_equal(resize(img, size), np.asarray(_pil(img).resize(size)))


def test_resize_to_the_same_size_is_a_copy():
    img = _camera_like(9, 7, 3)
    out = resize(img, (7, 9))
    np.testing.assert_array_equal(out, img)
    assert out is not img


def test_resize_grey(tmp_path):
    img = _camera_like(80, 120, 1, seed=3)
    np.testing.assert_array_equal(resize(img, (45, 31))[..., 0], np.asarray(_pil(img).resize((45, 31))))


def test_unfilter_library_builds_into_build(tmp_path):
    path = str(tmp_path / "a.png")
    save_png(path, _camera_like(5, 5, 3), filters=[4] * 5)
    read_png(path)
    lib = cuda_build.library_path("png_unfilter")
    assert lib.parent == cuda_build.BUILD_DIR and lib.parent.name == "build" and lib.exists()
    assert "png_unfilter" not in cuda_build.kernel_names()  # a host library, not a CUDA kernel


def test_failed_build_raises(tmp_path, monkeypatch):
    """No Python row loop stands behind the library: a failed build raises."""
    path = str(tmp_path / "a.png")
    save_png(path, _camera_like(5, 5, 3))
    monkeypatch.setattr(image_io, "_UNFILTER", None)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "_is_stale", lambda name: True)
    monkeypatch.setattr(cuda_build, "_compiler_command", lambda name, out: ["false"])
    with pytest.raises(RuntimeError, match="build failed for png_unfilter"):
        read_png(path)
    assert not hasattr(image_io, "_unfilter_row")


# Each mode's colour type at a bit depth the PNG specification does not
# allow for it (Pillow refuses each): grey+alpha at 4 bits, palette at 16,
# grey at 3, RGB at 1. The modes themselves read as Pillow reads them
# (tests/test_torch_image_decode.py).
_INVALID_LAYOUT = {"LA": (4, 4), "P": (16, 3), "I;16": (3, 0), "1": (1, 2)}


@pytest.mark.parametrize("mode", ["LA", "P", "I;16", "1"])
def test_unsupported_pngs_raise_naming_the_file(mode, tmp_path):
    path = tmp_path / f"other_{mode.replace(';', '')}.png"
    depth, ctype = _INVALID_LAYOUT[mode]
    header = struct.pack(">IIBBBBB", 8, 8, depth, ctype, 0, 0, 0)
    chunks = [(b"IHDR", header), (b"IDAT", zlib.compress(bytes(300))), (b"IEND", b"")]
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
        for tag, body in chunks))
    with pytest.raises(Exception):
        Image.open(path).load()
    with pytest.raises(ValueError, match=f"other_.*PNG layout \\(bit depth {depth}, colour type {ctype}"):
        load_image(str(path))


def test_interlaced_png_raises(tmp_path):
    """A file whose IHDR says Adam7 over rows laid out without it: the data's
    length does not match the seven passes."""
    path = tmp_path / "interlaced.png"
    save_png(str(path), _camera_like(4, 4, 3))
    data = bytearray(path.read_bytes())
    ihdr = 8 + 8
    data[ihdr + 12] = 1  # interlace method: Adam7
    data[ihdr + 13:ihdr + 17] = struct.pack(">I", zlib.crc32(bytes(data[ihdr - 4:ihdr + 13])) & 0xFFFFFFFF)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced.png.*interlace 1"):
        read_png(str(path))


def test_non_png_and_bad_filter_raise(tmp_path):
    """read_png reads PNGs only; the JPEG it refuses reads through
    load_image as the JAX package reads it (bitwise)."""
    jpeg = str(tmp_path / "photo.jpg")
    _pil(_camera_like(8, 8, 3)).save(jpeg)
    with pytest.raises(ValueError, match="photo.jpg: not a PNG"):
        read_png(jpeg)
    np.testing.assert_array_equal(load_image(jpeg), jax_load_image(jpeg))
    np.testing.assert_array_equal(load_image(jpeg, (5, 11)), jax_load_image(jpeg, (5, 11)))
    bad = tmp_path / "bad_filter.png"
    save_png(str(bad), _camera_like(3, 3, 1))
    raw = bytearray(zlib.decompress(_idat(bad.read_bytes())))
    raw[4] = 7  # the second row's filter byte
    _write_with_idat(bad, zlib.compress(bytes(raw)))
    with pytest.raises(ValueError, match="bad_filter.png: PNG row 1 has unknown filter type 7"):
        read_png(str(bad))


def _idat(data):
    pos = 8
    while True:
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            return data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _write_with_idat(path, idat):
    data = path.read_bytes()
    head = data[:8 + 25]  # signature and IHDR
    chunk = struct.pack(">I", len(idat)) + b"IDAT" + idat + struct.pack(">I", zlib.crc32(b"IDAT" + idat) & 0xFFFFFFFF)
    end = struct.pack(">I", 0) + b"IEND" + struct.pack(">I", zlib.crc32(b"IEND") & 0xFFFFFFFF)
    path.write_bytes(head + chunk + end)


def test_save_png_refuses_bad_input(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        save_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="filter type"):
        save_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint8), filters=[5] * 4)
