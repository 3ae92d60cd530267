"""The fixtures' encoders of the JPEG codings Pillow reads but does not
write (mlinerf_tpu_torch/data/fixtures.py: lossless, arithmetic-coded,
progressive with any scan script) and what the port's reader does at the
edges of those codings, each held against Pillow (libjpeg-turbo 3.x) and
the JAX package's ``load_image``: each encoder's files open in Pillow at
the mode and shape asked for, lossless ones exactly; what Pillow refuses
(SOF11, lossless YCbCr or YCCK, a lossless restart interval that splits an
MCU row, a lossless component in no scan, other precisions) the port
refuses by name; an arithmetic-coded magnitude or run that overflows reads
as Pillow reads it (libjpeg warns and decodes nothing more until the next
restart); an arithmetic-coded scan that reads past Pillow's
64 KiB read blocks, which Pillow cannot read, is refused as Pillow refuses
it, at the same byte, and reads as Pillow reads it given larger blocks."""

import io

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import camera_like
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.utils import image_io
from mlinerf_tpu_torch.utils.image_io import load_image, read_image

MODES = {1: "L", 3: "RGB", 4: "CMYK"}


def _pillow(data):
    with Image.open(io.BytesIO(data)) as im:
        return im.mode, np.asarray(im)


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_round_trips_through_pillow(predictor):
    """Every predictor and point transform, with restarts, subsampling and
    separate scans: Pillow gives back the samples (shifted by the point
    transform, a subsampled component replicated)."""
    for c in (1, 3, 4):
        img = camera_like(21, 26, c, seed=predictor + c)
        for pt in (0, predictor % 4):
            mode, got = _pillow(fixtures.encode_jpeg_lossless(img, predictor=predictor, point_transform=pt,
                                                              restart_interval=26 * (pt + 1)))
            want = (img >> pt) << pt
            assert mode == MODES[c]
            np.testing.assert_array_equal(got.reshape(img.shape), 255 - want if c == 4 else want)
    rgb = camera_like(21, 26, 3, seed=predictor)
    mode, got = _pillow(fixtures.encode_jpeg_lossless(rgb, predictor=predictor, interleaved=False))
    np.testing.assert_array_equal(got, rgb)
    mode, got = _pillow(fixtures.encode_jpeg_lossless(rgb, predictor=predictor, sampling=[(2, 2), (1, 1), (1, 1)]))
    assert mode == "RGB" and got.shape == rgb.shape
    np.testing.assert_array_equal(got[..., 0], rgb[..., 0])
    chroma = np.repeat(np.repeat(got[::2, ::2, 1:], 2, 0), 2, 1)[:21, :26]  # replicated, not interpolated
    np.testing.assert_array_equal(got[..., 1:], chroma)


@pytest.mark.parametrize("coding,progressive", [("arithmetic", False), ("arithmetic", True), ("huffman", True)],
                         ids=["SOF9", "SOF10", "SOF2"])
def test_dct_encoders_open_in_pillow(coding, progressive):
    """Grey, RGB at each subsampling and YCCK, with and without restarts
    and DAC conditioning: Pillow reads each at its mode and shape, and to
    the same samples as the baseline encoder's file of the same quantised
    coefficients (the progressive script refines every coefficient fully)."""
    for c, subsampling in [(1, "4:4:4"), (3, "4:4:4"), (3, "4:2:0"), (3, "4:2:2"), (3, "4:4:0"), (3, "4:1:1"),
                           (4, "4:2:0")]:
        img = camera_like(27, 35, c, seed=c)
        for restart, conditioning in ((0, None), (2, ((1, 4), 8) if coding == "arithmetic" else None)):
            data = fixtures.encode_jpeg_dct(img, 95, subsampling, coding=coding,
                                            scans=fixtures.progressive_scans(c) if progressive else None,
                                            restart_interval=restart, conditioning=conditioning, ycck=c == 4)
            mode, got = _pillow(data)
            assert mode == MODES[c] and got.shape == (27, 35) + ((c,) if c > 1 else ())
            np.testing.assert_array_equal(got, _pillow(fixtures.encode_jpeg(img, 95, subsampling, ycck=c == 4))[1])
    with pytest.raises(ValueError, match="coding"):
        fixtures.encode_jpeg_dct(img, coding="gzip")
    with pytest.raises(ValueError, match="conditioning"):
        fixtures.encode_jpeg_dct(img[..., :3], conditioning=((0, 1), 5))
    with pytest.raises(ValueError, match="encode_jpeg's"):
        fixtures.encode_jpeg_dct(img[..., :3], coding="huffman")


def test_lossless_encoder_refuses_what_it_cannot_write():
    with pytest.raises(ValueError, match="2 channels"):
        fixtures.encode_jpeg_lossless(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="predictor 8"):
        fixtures.encode_jpeg_lossless(np.zeros((4, 4), np.uint8), predictor=8)
    with pytest.raises(ValueError, match="not a whole number of MCU rows"):
        fixtures.encode_jpeg_lossless(np.zeros((4, 6), np.uint8), restart_interval=4)


def test_optimal_tables_stay_within_16_bits():
    """Fibonacci counts force a Huffman code deeper than 16 bits before
    K.3's adjustment: the table stays within 16 bits with a code left free."""
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, np.int64)
    counts[:40] = fib
    bits, symbols = fixtures._optimal_table(counts)
    assert len(bits) == 16 and sum(bits) == len(symbols) == 40
    assert sum(n * 2.0 ** -(length + 1) for length, n in enumerate(bits)) < 1.0  # Kraft, the all-ones code free


def _planted(decisions):
    """An 8x8 grey SOF9 file whose scan codes ``decisions`` [(area, bin,
    bit)] with the QM coder, area "dc" or "ac" (table 0's statistics)."""
    coder = fixtures._ArithScan({0}, {0}, ((0, 1), 5))
    for area, index, bit in decisions:
        coder.code(coder.dc_stats[0] if area == "dc" else coder.ac_stats[0], index, bit)
    coder.flush()
    head = fixtures._jpeg_head(0xC9, 8, 8, [(1, 1)], [0], [np.full(64, 8)], fixtures._JFIF)
    sos = fixtures._segment(0xDA, bytes([1, 1, 0, 0, 63, 0]))
    return head + sos + bytes(coder.out) + b"\xff\xd9"


PLANTED = {
    # A DC difference whose magnitude category goes on past 15 bits.
    "dc_magnitude": ([("dc", 0, 1), ("dc", 1, 0), ("dc", 2, 1)] + [("dc", 20 + i, 1) for i in range(15)],
                     "DC magnitude"),
    # A block whose zero run passes coefficient 63.
    "ac_run": ([("dc", 0, 0), ("ac", 0, 0)] + [("ac", 3 * k + 1, 0) for k in range(63)], "run of zero coefficients"),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_arithmetic_overflow_raises_where_libjpeg_warns(case, tmp_path):
    """libjpeg warns (JWRN_ARITH_BAD_CODE), decodes nothing more until the
    next restart, and Pillow reads on: the port gives Pillow's array."""
    decisions, _ = PLANTED[case]
    path = _write(tmp_path, f"{case}.jpg", _planted(decisions))
    mode, want = _pillow(open(path, "rb").read())
    assert mode == "L"
    got, got_mode = read_image(path)
    assert got_mode == mode and got.dtype == want.dtype
    assert np.array_equal(got.reshape(want.shape), want)


def _patched(data, find, offset, value):
    data = bytearray(data)
    data[data.find(find) + offset] = value
    return bytes(data)


def _lossless_rgb(**kw):
    return fixtures.encode_jpeg_lossless(camera_like(10, 12, 3, seed=1), **kw)


def _without_last_scan():
    data = fixtures.encode_jpeg_lossless(camera_like(10, 12, 3, seed=2), interleaved=False)
    return data[:data.rfind(b"\xff\xc4")] + b"\xff\xd9"  # the last scan's DHT, SOS and data


# What Pillow refuses of the lossless and arithmetic codings: (file, the
# port's error).
REFUSED = {
    "sof11": (lambda: _patched(fixtures.encode_jpeg_lossless(camera_like(8, 8, 1, seed=0)), b"\xff\xc3", 1, 0xCB),
              r"arithmetic-coded lossless JPEG \(SOF11\)"),
    "lossless_jfif": (lambda: _lossless_rgb(app="jfif"), "lossless JPEG in YCbCr"),
    "lossless_adobe_ycc": (lambda: _patched(_lossless_rgb(), b"Adobe", 11, 1), "lossless JPEG in YCbCr"),
    "lossless_ycck": (lambda: _patched(fixtures.encode_jpeg_lossless(camera_like(8, 8, 4, seed=0)), b"Adobe", 11, 2),
                      "lossless JPEG in YCCK"),
    "lossless_restart": (lambda: _patched(_lossless_rgb(restart_interval=12), b"\xff\xdd", 5, 5),
                         "restart interval of 5 MCUs is not a whole number of MCU rows"),
    "lossless_no_scan": (_without_last_scan, "lossless JPEG component in no scan"),
    "lossless_12_bit": (lambda: _patched(_lossless_rgb(), b"\xff\xc3", 4, 12), "12-bit sample precision"),
    "lossless_4_bit": (lambda: _patched(_lossless_rgb(), b"\xff\xc3", 4, 4), "4-bit sample precision"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_the_port_refuses(case, tmp_path):
    make, message = REFUSED[case]
    path = _write(tmp_path, f"{case}.jpg", make())
    with pytest.raises(Exception):
        _pillow(open(path, "rb").read())
    with pytest.raises(ValueError, match=f"{case}.jpg: JPEG: .*{message}"):
        load_image(path)


PAST_BLOCK = r"reads past Pillow's 65536-byte read block"


@pytest.mark.parametrize("progressive", [False, True], ids=["SOF9", "SOF10"])
def test_arithmetic_past_pillows_read_block(progressive, tmp_path, monkeypatch):
    """Pillow feeds libjpeg 64 KiB at a time and libjpeg's arithmetic
    decoder cannot wait for more (JERR_CANT_SUSPEND): Pillow, and with it
    the JAX package's load_image, raises on a larger arithmetic-coded file,
    and so does the port. Given the whole file in one block, each reads it,
    to the same samples."""
    img = np.random.default_rng(5).integers(0, 256, (230, 230, 3), dtype=np.uint8)
    data = fixtures.encode_jpeg_dct(img, 90, "4:4:4", coding="arithmetic",
                                    scans=fixtures.progressive_scans(3) if progressive else None)
    assert len(data) > 65536
    path = _write(tmp_path, "big.jpg", data)
    with pytest.raises(OSError):
        jax_load_image(path)
    with pytest.raises(ValueError, match=f"big.jpg: JPEG: an arithmetic-coded scan {PAST_BLOCK}"):
        load_image(path)
    with Image.open(path) as im:
        im.decodermaxblock = len(data)
        want = np.asarray(im)
    monkeypatch.setattr(image_io, "PILLOW_READ_BLOCK", len(data))
    got, mode = read_image(path)
    assert mode == "RGB" and np.array_equal(got, want)


def _commented(data, where, at):
    """``data`` with a COM segment after SOI that moves its first scan's
    entropy-coded data to start at byte ``at`` (``where`` "start") or its
    end to byte ``at`` (``where`` "end": the file is ``at`` bytes long)."""
    sos = data.find(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    pad = at - start - 4 if where == "start" else at - len(data) - 4
    return data[:2] + fixtures._segment(0xFE, bytes(pad)) + data[2:]


# Where a small arithmetic-coded file lies against Pillow's first read
# block (bytes 0 to 65535): its first SOS segment ending on the block's
# last byte (the scan's first byte is not read yet) or one byte later
# (Pillow has then read the second block), the file ending on the block's
# last byte or one byte later (the decoder reads the code byte of the EOI
# marker that ends the last scan).
EDGES = {"sos_ends_block": ("start", 65536), "sos_past_block": ("start", 65537),
         "file_ends_block": ("end", 65536), "file_past_block": ("end", 65537)}


@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("kind", ["sequential", "restarts", "progressive"])
def test_arithmetic_read_block_edges_like_pillow(kind, edge, tmp_path):
    """The port refuses exactly where Pillow does, and reads what Pillow
    reads bitwise: a scan reads past the blocks Pillow had read when it
    started, or it does not."""
    img = camera_like(40, 48, 3, seed=9)
    data = fixtures.encode_jpeg_dct(img, 90, "4:2:0", coding="arithmetic", restart_interval=int(kind == "restarts"),
                                    scans=fixtures.progressive_scans(3) if kind == "progressive" else None)
    path = _write(tmp_path, f"{edge}.jpg", _commented(data, *EDGES[edge]))
    if edge in ("sos_ends_block", "file_past_block"):
        with pytest.raises(OSError):
            jax_load_image(path)
        with pytest.raises(ValueError, match=PAST_BLOCK):
            load_image(path)
    else:
        np.testing.assert_array_equal(load_image(path), jax_load_image(path))
