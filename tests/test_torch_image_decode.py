"""The port's image reader (mlinerf_tpu_torch/utils/image_io.py, with
csrc/jpeg_decode.cpp and csrc/png_unfilter.cpp) against Pillow and the JAX
package's ``load_image``, bitwise (``np.array_equal``), with and without
``size``: every file of the committed corpus (tests/torch_image_corpus,
written by tests/make_torch_image_corpus.py), freshly seeded random PNGs of
every bit depth, colour type and interlace, and seeded random JPEGs of every
option Pillow writes; the fixture encoder's JPEGs (4:4:4, 4:2:2, 4:2:0,
4:4:0, 4:1:1) read the same by Pillow and the port; seeded random files of
the codings Pillow does not write (lossless, arithmetic-coded, progressive
scripts that libjpeg smooths); the JPEG variants Pillow refuses, which the
port refuses by an error that names each."""

import hashlib
import io
import json
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import (CORPUS, DAMAGED_FRAME_SEED, DAMAGED_FRAME_SIZE, MANIFEST, camera_like, jpeg_scans,
                                     pillow_entry, pillow_outcome_entry, png_bytes, resize_sizes, sha256)
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.ops import cuda_build
from mlinerf_tpu_torch.utils import image_io
from mlinerf_tpu_torch.utils.image_io import load_image, read_image, resize

with open(MANIFEST) as _f:
    _MANIFEST = json.load(_f)
FILES = sorted(_MANIFEST["files"])
# Every file the manifest records, the corpus's and the timed frames': name -> Pillow's entry.
ENTRIES = dict(_MANIFEST["files"])
ENTRIES.update({t["file"]: {k: v for k, v in t.items() if k != "file"} for t in _MANIFEST["timed"].values()})
# (bit depth, colour type) of every PNG layout Pillow reads.
PNG_LAYOUTS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3), (8, 3), (8, 4),
               (16, 4), (8, 6), (16, 6)]
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _assert_like_jax(path, sizes):
    for size in [None, *sizes]:
        got, want = load_image(path, size), jax_load_image(path, size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, (size, got.shape, want.shape)
        assert np.array_equal(got, want), (path, size)


def _incomplete_low_ac(scans):
    """Whether a progressive file's scans leave any of the first nine AC
    coefficients of a component short of full precision (or unsent) while
    its DC is sent: the case libjpeg smooths."""
    bits = {}
    for comps, ss, se, ah, al in scans:
        for cid in comps:
            for k in range(ss, se + 1):
                bits[(cid, k)] = al
    ids = {cid for comps, *_ in scans for cid in comps}
    return all((cid, 0) in bits for cid in ids) and any(bits.get((cid, k), -1) != 0 for cid in ids
                                                         for k in range(1, 10))


def test_corpus_is_small_and_complete():
    sizes = [os.path.getsize(os.path.join(CORPUS, name)) for name in FILES]
    assert len(FILES) >= 15 and sum(sizes) < 300_000
    modes = {_MANIFEST["files"][name]["mode"] for name in FILES}
    assert modes == {"1", "L", "P", "I;16", "LA", "RGB", "RGBA", "CMYK"}
    samplings = {str(e.get("sampling")) for e in _MANIFEST["files"].values()}
    for luma in ([1, 1], [2, 1], [2, 2], [1, 2], [4, 1]):  # 4:4:4 4:2:2 4:2:0 4:4:0 4:1:1
        assert str([luma, [1, 1], [1, 1]]) in samplings, luma
    frames = {e.get("frame") for e in _MANIFEST["files"].values()}
    assert {"SOF0", "SOF1", "SOF2", "SOF3", "SOF9", "SOF10"} <= frames
    parsed = {}
    for name in FILES:
        if name.endswith(".jpg"):
            with open(os.path.join(CORPUS, name), "rb") as f:
                parsed[name] = (_MANIFEST["files"][name]["frame"], *jpeg_scans(f.read()))
    lossless = [(markers, scans) for frame, markers, scans in parsed.values() if frame == "SOF3"]
    assert {scans[0][1] for _, scans in lossless} == set(range(1, 8))  # every predictor
    assert any(0xDD in markers for markers, _ in lossless) and any(scans[0][4] for _, scans in lossless)
    arithmetic = [markers for frame, markers, _ in parsed.values() if frame in ("SOF9", "SOF10")]
    assert any(0xCC in m for m in arithmetic) and any(0xCC not in m for m in arithmetic)  # DAC and default
    smoothed = [name for name, (frame, _, scans) in parsed.items() if frame in ("SOF2", "SOF10")
                and _incomplete_low_ac(scans)]
    assert len(smoothed) >= 3 and {parsed[n][0] for n in smoothed} == {"SOF2", "SOF10"}


# The TIFF and BMP files beside them (tests/test_torch_image_containers.py)
# and the WebP files (tests/test_torch_webp.py).
PILLOW_ENTRIES = {**ENTRIES, **_MANIFEST["containers"], **_MANIFEST["webp"]}


@pytest.mark.parametrize("name", sorted(PILLOW_ENTRIES))
def test_pillow_still_reproduces_the_manifest(name):
    """The card's corpus gate compares with these hashes: Pillow here must
    still read every file to them."""
    assert pillow_entry(os.path.join(CORPUS, name)) == PILLOW_ENTRIES[name]


DAMAGED = _MANIFEST["damaged"]


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_corpus_reads_as_pillow_recorded(name):
    """The damaged files: Pillow here still reads (or refuses) each as the
    manifest records it, the card's gate compares with that record, and
    the port reads each to it, resized too, or refuses it by ValueError."""
    path = os.path.join(CORPUS, name)
    entry = DAMAGED[name]
    assert pillow_outcome_entry(path) == entry
    if "refused" in entry:
        with pytest.raises(ValueError):
            read_image(path)
        return
    arr, mode = read_image(path)
    assert mode == entry["mode"] and str(arr.dtype) == entry["dtype"] and sha256(arr) == entry["sha256"]
    for key, digest in entry["resized"].items():
        size = tuple(int(v) for v in key.split("x"))
        assert sha256(resize(arr, size, mode)) == digest, key


def test_damaged_frames_are_the_manifests(tmp_path):
    """fixtures.damaged_frames as chip_smoke.py writes them into its NRHints
    stand-in: the same bytes as the manifest records, which Pillow reads to
    the recorded array and the port reads to it too, libjpeg's warnings
    met where each frame's name says."""
    frames = fixtures.damaged_frames(DAMAGED_FRAME_SIZE, DAMAGED_FRAME_SEED)
    assert sorted(frames) == sorted(_MANIFEST["damaged_frames"])
    for name, (ext, data) in frames.items():
        entry = _MANIFEST["damaged_frames"][name]
        assert ext == entry["ext"] and hashlib.sha256(data).hexdigest() == entry["file_sha256"], name
        path = tmp_path / f"{name}{ext}"
        path.write_bytes(data)
        with Image.open(path) as im:
            assert im.mode == entry["mode"] and sha256(np.asarray(im)) == entry["sha256"]
        warnings = {}
        arr, mode = image_io.read_jpeg(str(path), warnings) if ext == ".jpg" else read_image(str(path))
        assert mode == entry["mode"] and sha256(arr) == entry["sha256"], name
        if name == "jpeg_progressive_bad_code":
            assert warnings["bad_huffman_code"] > 0
        elif ext == ".jpg":
            assert warnings["hit_marker"] == 1
    with pytest.raises(zlib.error):  # the damaged tail is past the last row: zlib meets it, Pillow does not
        zlib.decompress(frames["png_damaged_tail"][1][8 + 25 + 8:-16])


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_corpus_reads_like_jax_bitwise(name):
    path = os.path.join(CORPUS, name)
    entry = ENTRIES[name]
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


def random_scan_script(rng, c):
    """A valid progressive script of seeded random bands for c components:
    the DC first (interleaved or per component) at a random Al, each
    component's AC split into random bands, each sent at a random Al and
    refined to a random depth, some bands and some components' AC never
    sent; the bands' scans merged at random, each band's in order."""
    al_dc = int(rng.integers(0, 3))
    groups = [tuple(range(c))] if rng.random() < 0.6 else [(ci,) for ci in range(c)]
    scans = [(g, 0, 0, 0, al_dc) for g in groups]
    chains = []
    for ci in range(c):
        if rng.random() < 0.15:
            continue
        cuts = sorted({int(x) for x in rng.integers(2, 64, int(rng.integers(0, 4)))})
        for ss, se in zip([1] + cuts, [x - 1 for x in cuts] + [63]):
            if rng.random() < 0.15:
                continue
            al = int(rng.integers(0, 4))
            stop = int(rng.integers(0, al + 1)) if rng.random() < 0.35 else 0
            chains.append([((ci,), ss, se, 0, al)] + [((ci,), ss, se, a, a - 1) for a in range(al, stop, -1)])
    while chains:
        k = int(rng.integers(0, len(chains)))
        scans.append(chains[k].pop(0))
        if not chains[k]:
            chains.pop(k)
    dc_to = int(rng.integers(0, al_dc + 1)) if rng.random() < 0.3 else 0
    return scans + [(tuple(range(c)), 0, 0, a, a - 1) for a in range(al_dc, dc_to, -1)]


def _coded_jpeg(coding, img, rng):
    """A seeded random file of ``img`` in ``coding`` through the fixtures'
    encoders: lossless (any predictor, point transform, sampling, scans and
    restarts), arithmetic-coded sequential (any DAC conditioning and
    restarts) or progressive, or a random progressive script (Huffman or
    arithmetic) that may leave low AC coefficients incomplete."""
    h, w, c = img.shape
    if coding == "lossless":
        sampling = None
        while c > 1 and rng.random() < 0.4 and not sampling:  # at most 10 samples per MCU, as libjpeg allows
            sampling = [tuple(int(v) for v in rng.choice([1, 2], 2)) for _ in range(c)]
            sampling = sampling if sum(h * v for h, v in sampling) <= 10 else None
        interleaved = c > 1 and rng.random() < 0.7
        mh = max(f[0] for f in sampling) if sampling else 1
        row = -(-w // mh) if interleaved else (w if not sampling or all(f[0] == mh for f in sampling) else 0)
        return fixtures.encode_jpeg_lossless(img, predictor=int(rng.integers(1, 8)),
                                             point_transform=int(rng.integers(0, 8)), sampling=sampling,
                                             restart_interval=row * int(rng.integers(0, 3)),
                                             app=None if c == 1 else str(rng.choice(["adobe", "none"])),
                                             interleaved=interleaved)
    conditioning = (((int(rng.integers(0, 4)), int(rng.integers(4, 16))), int(rng.integers(0, 64)))
                    if rng.random() < 0.5 else None)
    subsampling = str(rng.choice(sorted(fixtures.JPEG_SUBSAMPLING)))
    quality = int(rng.choice([1, 10, 50, 75, 90, 100]))
    restart = int(rng.integers(0, 4))
    if coding == "arithmetic":
        scans = None
    elif coding == "arithmetic_progressive":
        scans = fixtures.progressive_scans(c)
    else:
        scans = random_scan_script(rng, c)
        if rng.random() < 0.5:
            return fixtures.encode_jpeg_dct(img, quality, subsampling, scans=scans, restart_interval=restart,
                                            ycck=c == 4)
    return fixtures.encode_jpeg_dct(img, quality, subsampling, coding="arithmetic", scans=scans,
                                    restart_interval=restart, conditioning=conditioning, ycck=c == 4)


JPEG_CODINGS = ["lossless", "arithmetic", "arithmetic_progressive", "smoothed"]


@pytest.mark.parametrize("mode,coding", [pytest.param(m, "pillow", id=m) for m in ("L", "RGB", "CMYK")]
                         + [pytest.param(m, c, id=f"{c}-{m}") for c in JPEG_CODINGS for m in ("L", "RGB", "CMYK")])
def test_random_jpegs_read_like_jax_bitwise(mode, coding, tmp_path):
    """Pillow's writer with seeded options: quality (1 to 100), subsampling,
    progressive, restart intervals, Adobe RGB, odd and tiny sizes; and the
    fixtures' encoders for the codings Pillow does not write, with seeded
    options (see _coded_jpeg)."""
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    if coding != "pillow":
        rng = np.random.default_rng([JPEG_CODINGS.index(coding), c])
        for i in range(25):
            h, w = (int(v) for v in rng.integers(1, 41 if i % 3 else 70, 2))
            img = camera_like(h, w, c, seed=i) if i % 2 else rng.integers(0, 256, (h, w, c), dtype=np.uint8)
            path = str(tmp_path / f"{coding}{i}.jpg")
            with open(path, "wb") as f:
                f.write(_coded_jpeg(coding, img, rng))
            _assert_like_jax(path, [(w + 5, h + 2), (max(1, w // 3), max(1, h // 2))])
        return
    rng = np.random.default_rng({"L": 1, "RGB": 2, "CMYK": 3}[mode])
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
    """As Image.open: a JPEG named .png, a PNG named .jpg, a TIFF named
    .png and a BMP named .jpg read by their content."""
    img = camera_like(10, 12, 3, seed=3)
    jpeg_as_png, png_as_jpeg = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    fixtures.save_jpeg(jpeg_as_png, img)
    image_io.save_png(png_as_jpeg, img)
    assert read_image(jpeg_as_png)[1] == read_image(png_as_jpeg)[1] == "RGB"
    np.testing.assert_array_equal(read_image(png_as_jpeg)[0], img)
    _assert_like_jax(jpeg_as_png, [])
    _assert_like_jax(png_as_jpeg, [])
    tiff_as_png, bmp_as_jpeg = tmp_path / "d.png", tmp_path / "e.jpg"
    tiff_as_png.write_bytes(fixtures.encode_tiff(img, "lzw", predictor=2))
    bmp_as_jpeg.write_bytes(fixtures.encode_bmp(img))
    for path in (str(tiff_as_png), str(bmp_as_jpeg)):
        arr, mode = read_image(path)
        assert mode == "RGB"
        np.testing.assert_array_equal(arr, img)
        _assert_like_jax(path, [(7, 5)])
    other = tmp_path / "c.gif"
    other.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="c.gif: not a PNG, JPEG, TIFF, BMP, WebP or JPEG 2000 file"):
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
    never sent, so libjpeg smooths its blocks (and estimates its DC)."""
    buf = io.BytesIO()
    Image.fromarray(camera_like(24, 24, 3, seed=1)).save(buf, "JPEG", progressive=True)
    data = buf.getvalue()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[1]] + b"\xff\xd9"  # the first scan is the interleaved DC scan


# Hand-made JPEG variants: (file, what Pillow does with it, the port's error,
# or None where the port reads it as the JAX package's load_image does). The
# lossless, arithmetic-coded and block-smoothing files are read bitwise;
# what Pillow refuses, the port refuses by an error that names it.
REFUSED = {
    "lossless": (_lossless, "reads", None),
    "arithmetic": (lambda: _with_frame_marker(0xC9), "reads", None),
    "hierarchical": (lambda: _with_frame_marker(0xC5), "raises", r"hierarchical JPEG \(SOF5\)"),
    "12_bit": (lambda: _with_precision(12), "raises", "12-bit sample precision"),
    "two_components": (_two_components, "raises", "2-component images"),
    "truncated": (_truncated, "raises", "truncated"),
    "block_smoothing": (_dc_only_progressive, "reads", None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_jpeg_refusals_name_the_feature(case, tmp_path):
    """A file Pillow refuses raises, naming the feature; a file Pillow reads
    reads bitwise as the JAX package reads it, resized too."""
    make, pillow, message = REFUSED[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make())
    if pillow == "reads":
        with Image.open(path) as im:
            want = np.asarray(im)
        got, mode = read_image(str(path))
        assert mode == im.mode and np.array_equal(got.reshape(want.shape), want)
        _assert_like_jax(str(path), [(7, 5), (31, 29)])
        return
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
