"""Damaged frames read as the JAX package reads them: each case's small
file, with one seeded bit flipped anywhere in it (200 flips a case, 1,400
for the cases in WIDE) or cut short at seeded points (20, or 140; with and
without its end marker, EOI for a JPEG and IEND for a PNG), goes through Pillow (the JAX package's ``load_image``) and
through the port's ``read_image``. Both must give the same mode, dtype and
array, or both must raise, the port a ValueError that names the cause.
One refusal counts as agreeing: where the port names rows that libtiff
leaves as its caller's buffer held them, Pillow's array must change with
what its heap held before (two fresh processes, glibc's MALLOC_PERTURB_ 1
and 2: those rows are uninitialised memory).

OPEN lists the damaged files still read otherwise than Pillow reads them,
by case and label, kept here for work on them and left out of the test;
ROADMAP.md §3 has why.

    python tests/test_torch_damaged_frames.py [case ...]

prints each case's disagreements, for work on a decoder.
"""

import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_image_corpus import camera_like  # noqa: E402
from mlinerf_tpu_torch.data import fixtures, tiff_encode  # noqa: E402
from mlinerf_tpu_torch.utils.image_io import read_image  # noqa: E402

FLIPS = 200
CUTS = 20
# The cases of the wider fuzz that found libtiff's old-style JPEG and ZSTD
# divergences take 7 times as many (1,400 flips and 140 cuts).
WIDE = ("tiff_ojpeg", "tiff_ojpeg_interchange", "tiff_ojpeg_interchange_22", "tiff_zstd_pred2")
H, W = 48, 64


def _pil(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _rgb(seed=0):
    return camera_like(H, W, 3, seed=seed)


def _stray_rst(progressive):
    """A JPEG whose scan has an RST marker written over two of its bytes."""
    data = bytearray(_pil(Image.fromarray(_rgb(1)), "JPEG", quality=75, progressive=progressive))
    sos = data.find(b"\xff\xda")
    at = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big") + 40
    data[at:at + 2] = b"\xff\xd3"
    return bytes(data)


def _bw():
    return Image.fromarray(camera_like(H, W, 1, seed=5)[..., 0] > 127)


def _jpeg_cases():
    rgb = _rgb()
    dct = fixtures.encode_jpeg_dct
    return {
        "jpeg_baseline": _pil(Image.fromarray(rgb), "JPEG", quality=75),
        "jpeg_baseline_restart": _pil(Image.fromarray(rgb), "JPEG", quality=75, restart_marker_blocks=2),
        "jpeg_progressive": _pil(Image.fromarray(rgb), "JPEG", quality=75, progressive=True),
        "jpeg_grey_restart_rows": _pil(Image.fromarray(rgb[..., 0]), "JPEG", quality=90, restart_marker_rows=1),
        "jpeg_arith": dct(rgb, 90, "4:2:0", coding="arithmetic"),
        "jpeg_arith_progressive": dct(rgb, 90, "4:2:0", coding="arithmetic", scans=fixtures.progressive_scans(3),
                                      restart_interval=5),
        "jpeg_lossless": fixtures.encode_jpeg_lossless(rgb, predictor=4, restart_interval=2 * W),
        "jpeg_stray_rst": _stray_rst(False),
        "jpeg_stray_rst_progressive": _stray_rst(True),
    }


def _png_cases():
    rgba16 = np.concatenate([_rgb(2), camera_like(H, W, 1, seed=3)], -1).astype(np.uint16) * 257
    return {
        "png_rgb": _pil(Image.fromarray(_rgb()), "PNG"),
        "png_rgba16": _png_rgba16(rgba16),
        "png_palette": _pil(Image.fromarray(_rgb()).quantize(64), "PNG"),
    }


def _png_rgba16(samples):
    from make_torch_image_corpus import png_bytes
    return png_bytes(samples, 16, 6)


def _tiff_cases():
    rgb, grey = _rgb(4), camera_like(H, W, 1, seed=6)[..., 0]
    tif = fixtures.encode_tiff
    return {
        "tiff_none": _pil(Image.fromarray(rgb), "TIFF"),
        "tiff_lzw": _pil(Image.fromarray(rgb), "TIFF", compression="tiff_lzw"),
        "tiff_deflate": _pil(Image.fromarray(rgb), "TIFF", compression="tiff_adobe_deflate"),
        "tiff_packbits": _pil(Image.fromarray(rgb), "TIFF", compression="packbits"),
        "tiff_jpeg": _pil(Image.fromarray(rgb), "TIFF", compression="jpeg", tiffinfo={278: 16}),
        "tiff_ojpeg": tiff_encode.ojpeg_encode(rgb, "tables", (2, 2), rows_per_strip=16),
        "tiff_g3_2d": _pil(_bw(), "TIFF", compression="group3", tiffinfo={292: 1}),
        "tiff_g4": _pil(_bw(), "TIFF", compression="group4"),
        "tiff_lzma": _pil(Image.fromarray(rgb), "TIFF", compression="lzma"),
        "tiff_zstd": _pil(Image.fromarray(rgb), "TIFF", compression="zstd"),
        "tiff_deflate_ycbcr": tif(rgb, "adobe_deflate", photometric=6, ycbcr_subsampling=(2, 1)),
        "tiff_lzma_ycbcr": tif(rgb, "lzma", photometric=6, ycbcr_subsampling=(2, 2)),
        "tiff_grey_none": tif(grey, "none"),
        # The wider fuzz's files: old-style JPEG in the interchange form (1x1
        # in 8-row strips, 2x2 in 16-row strips), Group 4 in 13-row strips,
        # ZSTD with predictor 2.
        "tiff_ojpeg_interchange": tiff_encode.ojpeg_encode(rgb, "interchange", (1, 1), rows_per_strip=8),
        "tiff_ojpeg_interchange_22": tiff_encode.ojpeg_encode(rgb, "interchange", (2, 2), rows_per_strip=16),
        "tiff_g4_13": tif(np.asarray(_bw())[..., None].astype(np.uint8), "group4", rows_per_strip=13),
        "tiff_zstd_pred2": tif(rgb, "zstd", predictor=2),
    }


def _bmp_cases():
    grey = camera_like(H, W, 1, seed=7)[..., 0]
    palette = np.random.default_rng(7).integers(0, 256, (256, 3))
    return {
        "bmp_24": _pil(Image.fromarray(_rgb()), "BMP"),
        "bmp_rle8": fixtures.encode_bmp(grey // 16 * 3, 8, "rle8", palette=palette),
    }


def _webp_cases():
    rgba = np.concatenate([_rgb(8), camera_like(H, W, 1, seed=9)], -1)
    return {
        "webp_lossy": _pil(Image.fromarray(_rgb()), "WEBP", quality=75),
        "webp_lossy_alpha": _pil(Image.fromarray(rgba, "RGBA"), "WEBP", quality=75),
        "webp_lossless": _pil(Image.fromarray(_rgb()), "WEBP", lossless=True),
        "webp_partitions": fixtures.encode_webp(_rgb(10), partitions=4),
    }


def _jpeg2000_cases():
    return {
        "jp2_53": _pil(Image.fromarray(_rgb()), "JPEG2000", irreversible=False),
        "j2k_97": _pil(Image.fromarray(_rgb()), "JPEG2000", irreversible=True, no_jp2=True),
        "j2k_cinema4k_poc": _pil(Image.fromarray(_rgb()), "JPEG2000", cinema_mode="cinema4k-24", no_jp2=True),
        "jp2_styles_layers": fixtures.encode_jpeg2000(_rgb(11), "jp2", style=0x3F, layers=2),
        "jp2_part_two": fixtures.encode_jpeg2000(_rgb(12), "jp2", ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)],
                                                 roi=[0], packed="ppt", style=0x14, layers=2),
    }


def cases():
    """{case: the undamaged file's bytes}."""
    out = {}
    for make in (_jpeg_cases, _png_cases, _tiff_cases, _bmp_cases, _webp_cases, _jpeg2000_cases):
        out.update(make())
    return out


_END = {"jpeg": b"\xff\xd9", "png": b"\x00\x00\x00\x00IEND\xaeB`\x82"}


def damaged(case, data):
    """[(label, bytes)]: the seeded flips and cuts of one case's file."""
    rng = np.random.default_rng(list(case.encode()))
    scale = 7 if case in WIDE else 1
    out = []
    for bit in rng.integers(0, len(data) * 8, FLIPS * scale):
        d = bytearray(data)
        d[bit // 8] ^= 1 << (bit % 8)
        out.append((f"flip bit {bit % 8} of byte {bit // 8}", bytes(d)))
    end = _END.get(case.split("_")[0])
    for at in sorted(rng.integers(len(data) // 8, len(data) - 1, CUTS * scale)):
        out.append((f"cut at {at}", data[:at]))
        if end is not None:
            out.append((f"cut at {at}, end marker", data[:at] + end))
    return out


def pillow_outcome(data):
    """(mode, array) of Pillow's reading, or the exception's text."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return im.mode, np.asarray(im)
    except Exception as e:  # noqa: BLE001  (Pillow's refusals are of many kinds)
        return f"{type(e).__name__}: {e}"


def port_outcome(path):
    try:
        arr, mode = read_image(path)
        return mode, arr
    except ValueError as e:
        return f"ValueError: {e}"


_HASH_IN_FRESH_PROCESS = (
    "import hashlib, sys\nimport numpy as np\nfrom PIL import Image\n"
    "print(hashlib.sha256(np.asarray(Image.open(sys.argv[1])).tobytes()).hexdigest())")


def _pillow_varies(path):
    """Whether Pillow's array of the file depends on what its buffers held
    before: read in two fresh processes whose heap allocations glibc fills
    with different bytes (MALLOC_PERTURB_), rows that libtiff leaves as
    its caller's buffer held them read differently."""
    seen = set()
    for perturb in ("1", "2"):
        run = subprocess.run([sys.executable, "-c", _HASH_IN_FRESH_PROCESS, path], capture_output=True, text=True,
                             env={**os.environ, "MALLOC_PERTURB_": perturb})
        seen.add(run.stdout.strip())
    return len(seen) > 1


def _agree(want, got, path=None):
    if isinstance(want, str) or isinstance(got, str):
        if isinstance(got, str) and not got.startswith("ValueError"):
            return False
        if isinstance(got, str) and not isinstance(want, str) and "undefined" in got and path is not None:
            # The port refuses rows Pillow's reading leaves undefined: they
            # must really vary from one reading to the next.
            return _pillow_varies(path)
        return isinstance(want, str) and isinstance(got, str)
    (wm, wa), (gm, ga) = want, got
    if wm != gm or wa.dtype != ga.dtype or wa.size != ga.size:
        return False
    return ga.shape[:2] == wa.shape[:2] and np.array_equal(ga.reshape(wa.shape), wa)


def _describe(outcome):
    if isinstance(outcome, str):
        return outcome[:160]
    mode, arr = outcome
    return f"{mode} {arr.dtype} {arr.shape}"


def disagreements(case, data, tmpdir, skip=()):
    """[(label, Pillow's outcome, the port's)] where the two differ, over
    the case's damaged files but those labelled in ``skip``."""
    out = []
    path = os.path.join(tmpdir, f"{case}.bin")
    for label, d in damaged(case, data):
        if label in skip:
            continue
        with open(path, "wb") as f:
            f.write(d)
        want = pillow_outcome(d)
        try:
            got = port_outcome(path)
        except Exception as e:  # noqa: BLE001
            got = f"{type(e).__name__}: {e}"
        if _agree(want, got, path):
            continue
        note = ""
        if not isinstance(want, str) and not isinstance(got, str) and want[0] == got[0] \
                and got[1].size == want[1].size:
            diff = np.abs(want[1].astype(np.int64) - got[1].reshape(want[1].shape).astype(np.int64))
            note = f"; {(diff.reshape(diff.shape[0], diff.shape[1], -1).max(-1) > 0).sum()} pixels differ, " \
                   f"by up to {diff.max()}"
        out.append((label, _describe(want), _describe(got) + note))
    return out


CASES = cases()
# Damaged files the port still reads otherwise than Pillow, by case and
# label, with the port's refusal: none.
OPEN = {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_damaged_frames_read_as_pillow_reads_them(case, tmp_path):
    bad = disagreements(case, CASES[case], str(tmp_path), skip=OPEN.get(case, {}))
    assert not bad, f"{len(bad)} disagreements with Pillow, the first: {bad[:3]}"


def test_open_damage_is_refused_naming_its_cause(tmp_path):
    """Each damaged file in OPEN: Pillow reads it, the port raises a
    ValueError naming why it cannot read it the same way."""
    for case, labels in sorted(OPEN.items()):
        files = dict(damaged(case, CASES[case]))
        for label, cause in labels.items():
            path = str(tmp_path / f"{case}.bin")
            with open(path, "wb") as f:
                f.write(files[label])
            assert not isinstance(pillow_outcome(files[label]), str), (case, label)
            got = port_outcome(path)
            assert isinstance(got, str) and got.startswith("ValueError") and cause in got, (case, label, got)


def test_unknown_predictor_fails_as_libtiff_fails_it(tmp_path):
    """A ZSTD file whose Predictor holds a value libtiff does not know (the
    wider fuzz's flip of its top bit, 2 | 0x8000): libtiff's PredictorSetup
    fails every strip and Pillow refuses the file; the port raises naming
    the field."""
    import struct

    data = bytearray(CASES["tiff_zstd_pred2"])
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, at)[0] == 317:
            struct.pack_into("<H", data, at + 8, 2 | 0x8000)
    path = tmp_path / "predictor.tif"
    path.write_bytes(bytes(data))
    assert isinstance(pillow_outcome(bytes(data)), str)
    with pytest.raises(ValueError, match="Predictor"):
        read_image(str(path))


if __name__ == "__main__":
    import time

    names = sys.argv[1:] or sorted(CASES)
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            t = time.time()
            bad = disagreements(name, CASES[name], tmp)
            print(f"{name}: {len(bad)} of {len(damaged(name, CASES[name]))} disagree ({time.time() - t:.1f} s)")
            for row in bad[:8]:
                print("   ", *row, sep=" | ")
