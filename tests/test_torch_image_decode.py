"""The port's image reader (mlinerf_tpu_torch/utils/image_io.py, with
csrc/jpeg_decode.cpp and csrc/png_unfilter.cpp) against Pillow and the JAX
package's ``load_image``, bitwise (``np.array_equal``), with and without
``size``: every file of the committed corpus (tests/torch_image_corpus,
written by tests/make_torch_image_corpus.py), freshly seeded random PNGs of
every bit depth, colour type and interlace, and seeded random JPEGs of every
option Pillow writes; the fixture encoder's JPEGs (4:4:4, 4:2:2, 4:2:0,
4:4:0, 4:1:1) read the same by Pillow and the port; the JPEG variants the
port refuses, each by an error that names it."""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import CORPUS, MANIFEST, camera_like, pillow_entry, png_bytes, resize_sizes, sha256
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.ops import cuda_build
from mlinerf_tpu_torch.utils import image_io
from mlinerf_tpu_torch.utils.image_io import load_image, read_image, resize

with open(MANIFEST) as _f:
    _MANIFEST = json.load(_f)
FILES = sorted(_MANIFEST["files"])
# (bit depth, colour type) of every PNG layout Pillow reads.
PNG_LAYOUTS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3), (8, 3), (8, 4),
               (16, 4), (8, 6), (16, 6)]
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _assert_like_jax(path, sizes):
    for size in [None, *sizes]:
        got, want = load_image(path, size), jax_load_image(path, size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, (size, got.shape, want.shape)
        assert np.array_equal(got, want), (path, size)


def test_corpus_is_small_and_complete():
    sizes = [os.path.getsize(os.path.join(CORPUS, name)) for name in FILES]
    assert len(FILES) >= 15 and sum(sizes) < 300_000
    modes = {_MANIFEST["files"][name]["mode"] for name in FILES}
    assert modes == {"1", "L", "P", "I;16", "LA", "RGB", "RGBA", "CMYK"}
    samplings = {str(e.get("sampling")) for e in _MANIFEST["files"].values()}
    for luma in ([1, 1], [2, 1], [2, 2], [1, 2], [4, 1]):  # 4:4:4 4:2:2 4:2:0 4:4:0 4:1:1
        assert str([luma, [1, 1], [1, 1]]) in samplings, luma
    frames = {e.get("frame") for e in _MANIFEST["files"].values()}
    assert {"SOF0", "SOF1", "SOF2"} <= frames


@pytest.mark.parametrize("name", FILES)
def test_pillow_still_reproduces_the_manifest(name):
    """The card's corpus gate compares with these hashes: Pillow here must
    still read every file to them."""
    assert pillow_entry(os.path.join(CORPUS, name)) == _MANIFEST["files"][name]


@pytest.mark.parametrize("name", FILES)
def test_corpus_reads_like_jax_bitwise(name):
    path = os.path.join(CORPUS, name)
    entry = _MANIFEST["files"][name]
    arr, mode = read_image(path)
    assert mode == entry["mode"] and sha256(arr) == entry["sha256"]
    assert list(arr.shape) == entry["shape"] + ([1] if len(entry["shape"]) == 2 else [])
    sizes = resize_sizes(arr.shape[1], arr.shape[0])
    for size in sizes:
        assert sha256(resize(arr, size, mode)) == entry["resized"][f"{size[0]}x{size[1]}"], size
    _assert_like_jax(path, sizes)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("layout", PNG_LAYOUTS, ids=lambda d: f"depth{d[0]}_ctype{d[1]}")
def test_random_pngs_read_like_jax_bitwise(layout, interlace, tmp_path):
    """Seeded random samples at every layout, each row's filter drawn at
    random, sizes that leave Adam7 passes empty and partial."""
    depth, ctype = layout
    rng = np.random.default_rng(depth * 10 + ctype + 100 * interlace)
    for h, w in ((1, 1), (3, 5), (13, 22)):
        samples = rng.integers(0, 1 << depth, (h, w, SAMPLES[ctype]))
        palette = rng.integers(0, 256, 3 << depth) if ctype == 3 else None
        path = str(tmp_path / f"r{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(samples, depth, ctype, interlace=interlace, rng=rng, palette=palette))
        arr, mode = read_image(path)
        with Image.open(path) as im:
            assert mode == im.mode
            want = np.asarray(im)
        assert np.array_equal(arr.reshape(want.shape), want)
        _assert_like_jax(path, [(w + 3, 2 * h + 1), (max(1, w // 2), max(1, (2 * h) // 3))])


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
def test_random_jpegs_read_like_jax_bitwise(mode, tmp_path):
    """Pillow's writer with seeded options: quality (1 to 100), subsampling,
    progressive, restart intervals, Adobe RGB, odd and tiny sizes."""
    rng = np.random.default_rng({"L": 1, "RGB": 2, "CMYK": 3}[mode])
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    for i in range(12):
        h, w = (int(v) for v in rng.integers(1, 41, 2))
        img = camera_like(h, w, c, seed=i) if i % 2 else rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        options = dict(quality=int(rng.choice([1, 10, 50, 75, 95, 100])), progressive=bool(rng.random() < 0.4))
        if mode == "RGB" and rng.random() < 0.2:
            options.update(keep_rgb=True, subsampling="4:4:4")
        else:
            options["subsampling"] = str(rng.choice(["4:4:4", "4:2:2", "4:2:0"]))
        if rng.random() < 0.4:
            options["restart_marker_blocks"] = int(rng.integers(1, 4))
        path = str(tmp_path / f"r{i}.jpg")
        Image.fromarray(img[..., 0] if c == 1 else img, mode).save(path, **options)
        _assert_like_jax(path, [(w + 5, h + 2), (max(1, w // 3), max(1, h // 2))])


@pytest.mark.parametrize("subsampling", sorted(fixtures.JPEG_SUBSAMPLING))
def test_fixture_encoder_round_trip(subsampling, tmp_path):
    """Pillow decodes the fixture encoder's JPEG; the port decodes it to the
    same arrays; it stays near the image it encoded."""
    img = camera_like(37, 53, 3, seed=5)
    path = str(tmp_path / "enc.jpg")
    fixtures.save_jpeg(path, img, quality=95, subsampling=subsampling)
    arr, mode = read_image(path)
    with Image.open(path) as im:
        assert im.mode == mode == "RGB" and im.size == (53, 37)
        assert np.array_equal(arr, np.asarray(im))
    luma = np.asarray([0.299, 0.587, 0.114])  # not subsampled: within a few levels at quality 95
    assert np.abs((arr.astype(float) - img) @ luma).mean() < 3.0
    _assert_like_jax(path, [(20, 14)])


def test_fixture_encoder_grey_and_ycck(tmp_path):
    grey, cmyk = str(tmp_path / "grey.jpg"), str(tmp_path / "ycck.jpg")
    with open(grey, "wb") as f:
        f.write(fixtures.encode_jpeg(camera_like(9, 30, 1, seed=1), quality=50))
    with open(cmyk, "wb") as f:
        f.write(fixtures.encode_jpeg(camera_like(21, 11, 4, seed=2), quality=70, subsampling="4:4:0", ycck=True))
    for path, mode in ((grey, "L"), (cmyk, "CMYK")):
        assert read_image(path)[1] == mode
        _assert_like_jax(path, [(7, 5)])
    with pytest.raises(ValueError, match="2 channels"):
        fixtures.encode_jpeg(np.zeros((8, 8, 2), np.uint8))


def test_signature_not_extension_decides(tmp_path):
    """As Image.open: a JPEG named .png and a PNG named .jpg read by their
    content."""
    img = camera_like(10, 12, 3, seed=3)
    jpeg_as_png, png_as_jpeg = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    fixtures.save_jpeg(jpeg_as_png, img)
    image_io.save_png(png_as_jpeg, img)
    assert read_image(jpeg_as_png)[1] == read_image(png_as_jpeg)[1] == "RGB"
    np.testing.assert_array_equal(read_image(png_as_jpeg)[0], img)
    _assert_like_jax(jpeg_as_png, [])
    _assert_like_jax(png_as_jpeg, [])
    other = tmp_path / "c.gif"
    other.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="c.gif: not a PNG or JPEG file"):
        read_image(str(other))


def _baseline_grey():
    buf = io.BytesIO()
    Image.fromarray(camera_like(16, 16, 1, seed=0)[..., 0], "L").save(buf, "JPEG")
    return bytearray(buf.getvalue())


def _with_frame_marker(marker):
    data = _baseline_grey()
    data[data.find(b"\xff\xc0") + 1] = marker
    return bytes(data)


def _lossless():
    """A valid lossless (SOF3) 16x16 grey JPEG of 128s: predictor 1, each
    sample's difference 0, the standard DC table's 2-bit code 00 each."""
    data = bytes(_baseline_grey())
    sof, sos = data.find(b"\xff\xc0"), data.find(b"\xff\xda")
    header = bytearray(data[:sos + 10])  # up to the scan header's Ss, Se, Ah/Al
    header[sof + 1] = 0xC3
    header[sos + 7:sos + 10] = bytes([1, 0, 0])
    return bytes(header) + bytes(16 * 16 * 2 // 8) + b"\xff\xd9"


def _with_precision(bits):
    data = _baseline_grey()
    data[data.find(b"\xff\xc0") + 4] = bits
    return bytes(data)


def _two_components():
    data = bytes(_baseline_grey())
    sof = data.find(b"\xff\xc0")
    length = int.from_bytes(data[sof + 2:sof + 4], "big")
    body = data[sof + 4:sof + 2 + length]  # precision, height, width, component count, components
    body = body[:5] + bytes([2]) + body[6:] + bytes([2, 0x11, 0])
    return data[:sof + 2] + (len(body) + 2).to_bytes(2, "big") + body + data[sof + 2 + length:]


def _truncated():
    data = _baseline_grey()
    return bytes(data[:len(data) * 2 // 3])


def _dc_only_progressive():
    """A progressive JPEG cut after its DC scans: its AC coefficients are
    never sent, so libjpeg smooths its blocks."""
    buf = io.BytesIO()
    Image.fromarray(camera_like(24, 24, 3, seed=1)).save(buf, "JPEG", progressive=True)
    data = buf.getvalue()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[1]] + b"\xff\xd9"  # the first scan is the interleaved DC scan


# (file, what Pillow does with it, the port's error). Pillow reads lossless
# and arithmetic-coded frames (libjpeg-turbo 3.x decodes them) and no
# encoder here writes them: the port refuses them (ROADMAP, open image rows).
REFUSED = {
    "lossless": (_lossless, "reads", r"lossless JPEG \(SOF3\)"),
    "arithmetic": (lambda: _with_frame_marker(0xC9), "reads", r"arithmetic-coded JPEG \(SOF9\)"),
    "hierarchical": (lambda: _with_frame_marker(0xC5), "raises", r"hierarchical JPEG \(SOF5\)"),
    "12_bit": (lambda: _with_precision(12), "raises", "12-bit sample precision"),
    "two_components": (_two_components, "raises", "2-component images"),
    "truncated": (_truncated, "raises", "truncated"),
    "block_smoothing": (_dc_only_progressive, "reads", "block smoothing"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_jpeg_refusals_name_the_feature(case, tmp_path):
    make, pillow, message = REFUSED[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make())
    if pillow == "reads":
        with Image.open(path) as im:
            im.load()
    else:
        with pytest.raises(Exception):
            with Image.open(path) as im:
                im.load()
    with pytest.raises(ValueError, match=f"{case}.jpg: JPEG: .*{message}"):
        load_image(str(path))


def test_jpeg_library_builds_into_build(tmp_path):
    fixtures.save_jpeg(str(tmp_path / "probe.jpg"), camera_like(8, 8, 3, seed=0))
    read_image(str(tmp_path / "probe.jpg"))
    lib = cuda_build.library_path("jpeg_decode")
    assert lib.parent == cuda_build.BUILD_DIR and lib.exists()
    assert "jpeg_decode" not in cuda_build.kernel_names()  # a host library, not a CUDA kernel


def test_failed_jpeg_build_raises(tmp_path, monkeypatch):
    """No Python decoder stands behind the library: a failed build raises."""
    path = str(tmp_path / "a.jpg")
    fixtures.save_jpeg(path, camera_like(8, 8, 3, seed=0))
    monkeypatch.setattr(image_io, "_JPEG", None)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "_is_stale", lambda name: True)
    monkeypatch.setattr(cuda_build, "_compiler_command", lambda name, out: ["false"])
    with pytest.raises(RuntimeError, match="build failed for jpeg_decode"):
        read_image(path)


@pytest.mark.parametrize("mode", ["1", "P"])
def test_nearest_modes_resize_by_pillows_steps(mode, tmp_path):
    """"1" and "P" resize by the nearest pixel at Pillow's accumulated
    positions, up and down, including ratios whose positions round near a
    pixel edge."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 2 if mode == "1" else 256, (31, 47)).astype(np.uint8)
    im = Image.fromarray(src * 255 if mode == "1" else src, "L").convert(mode)
    arr = np.asarray(im)[..., None]
    for size in ((47 * 3, 31 * 7), (7, 3), (46, 30), (48, 32), (1, 1), (470, 3)):
        want = np.asarray(im.resize(size))
        assert np.array_equal(resize(arr, size, mode)[..., 0], want), size


# What the JAX package's load_image returns where Pillow's array is not an
# image's colours, mirrored (ROADMAP, faults of the reference that the port
# mirrors): (file, the set or range of its values).
MIRRORED = {"png_p8_trns.png": "palette indices / 255", "png_grey16.png": "uint16 / 255, up to 257",
            "png_grey1.png": "bool / 255: 0 or 1/255"}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_reference_faults_are_mirrored(name):
    path = os.path.join(CORPUS, name)
    got = load_image(path)
    np.testing.assert_array_equal(got, jax_load_image(path))
    assert got.shape[-1] == 1
    if name == "png_p8_trns.png":  # indices, not the palette's RGB
        with Image.open(path) as im:
            assert np.array_equal(got[..., 0] * np.float32(255), np.asarray(im).astype(np.float32))
    elif name == "png_grey16.png":
        assert 1.0 < got.max() <= 65535 / 255
    else:
        assert set(np.unique(got).tolist()) == {0.0, np.float32(1) / np.float32(255)}
