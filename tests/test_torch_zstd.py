"""The port's Zstandard decoder (csrc/zstd_decode.cpp behind utils/zstd.py)
against libzstd 1.5 as libtiff 4.7's ZSTDDecode drives it inside Pillow
12.1, bitwise: every RFC 8878 path reached by some file of the committed
corpus (the decoder counts them); every single-bit corruption of a small
strip, Pillow's and the fixtures', failing exactly where Pillow fails and
reading to Pillow's array otherwise; libzstd's stream decoder at the
strip's end (a frame larger than the strip, a block that fills it exactly
before a corrupt one, a raw block cut short, a second frame, a frame
decoded in one pass); and seeded random frames of the fixture encoder
decoded to their source."""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import CORPUS, MANIFEST, camera_like
from mlinerf_tpu_torch.data import fixtures, tiff_encode
from mlinerf_tpu_torch.utils import image_containers, zstd
from mlinerf_tpu_torch.utils.image_io import read_image


def _pillow_or_none(path):
    try:
        with Image.open(path) as im:
            arr = np.asarray(im)
            return arr.reshape(arr.shape + (1,) * (3 - arr.ndim))
    except Exception:
        return None


def _same_as_pillow(path):
    """The port fails where Pillow fails, else reads Pillow's array;
    returns whether Pillow read it."""
    want = _pillow_or_none(path)
    if want is None:
        with pytest.raises(ValueError):
            read_image(path)
        return False
    got = read_image(path)[0]
    assert got.shape == want.shape and np.array_equal(got, want)
    return True


def test_corpus_reaches_every_path(tmp_path):
    """Each path the decoder counts is reached by some ZSTD file of the
    corpus (Pillow's and the fixtures'), but a skippable frame: libtiff
    reads no further than the first frame's end, so a skippable frame is
    read only where it comes first, and then the strip is short and both
    Pillow and the port refuse it."""
    with open(MANIFEST) as f:
        names = [n for n in json.load(f)["tiff_codings"] if "zstd" in n]
    zstd.reset_path_counts()
    for name in names:
        read_image(os.path.join(CORPUS, name))
    counts = zstd.path_counts()
    assert len(counts) == 25 and [p for p, c in counts.items() if c == 0] == ["skippable"], counts
    path = str(tmp_path / "skippable_first.tif")
    with open(path, "wb") as f:
        f.write(fixtures.encode_tiff(camera_like(8, 8, 3, seed=1), "zstd", skippable="before"))
    assert not _same_as_pillow(path) and zstd.path_counts()["skippable"] == 1


def _strips():
    rgb = camera_like(11, 13, 3, seed=21)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "TIFF", compression="zstd")
    return {"pillow": buf.getvalue(),
            "fixture_one_pass": fixtures.encode_tiff(rgb, "zstd", content_size=True, literals="huffman1"),
            "fixture_streaming": fixtures.encode_tiff(rgb, "zstd", predictor=2, block_size=128)}


@pytest.mark.parametrize("source", sorted(_strips()))
def test_every_bit_flip_fails_where_pillow_fails(source, tmp_path):
    data = _strips()[source]
    lay = image_containers.tiff_layout(source, data)
    path = str(tmp_path / "f.tif")
    read = set()
    for pos in range(lay.offsets[0], lay.offsets[0] + lay.byte_counts[0]):
        for bit in (0, 3, 6):
            d = bytearray(data)
            d[pos] ^= 1 << bit
            with open(path, "wb") as f:
                f.write(bytes(d))
            read.add(_same_as_pillow(path))
    assert read == {True, False}


_MAGIC = b"\x28\xb5\x2f\xfd"


def _frame(blocks, content_size=None) -> bytes:
    """A frame by hand: (kind, payload) blocks, the last flagged last; kind
    "raw", "reserved" (block type 3) or "cut" (a raw block's header for
    ``payload`` bytes followed by only half of them)."""
    if content_size is None:
        head = _MAGIC + bytes([0x00, 7 << 3])
    elif content_size < 256:  # single segment, a 1-byte content size
        head = _MAGIC + bytes([0x20, content_size])
    else:
        head = _MAGIC + bytes([0x60]) + (content_size - 256).to_bytes(2, "little")
    out = b""
    for i, (kind, payload) in enumerate(blocks):
        last = int(i == len(blocks) - 1)
        typ = {"raw": 0, "cut": 0, "reserved": 3}[kind]
        out += (last | (typ << 1) | (len(payload) << 3)).to_bytes(3, "little")
        out += payload[:len(payload) // 2] if kind == "cut" else payload
    return head + out


STREAM_CASES = {  # (frame, does Pillow read it)
    "larger_than_strip": (lambda s, m: _frame([("raw", s), ("raw", m)]), True),
    "exact_then_reserved": (lambda s, m: _frame([("raw", s), ("reserved", b"")]), False),
    "exact_then_cut": (lambda s, m: _frame([("raw", s), ("cut", m)]), True),
    "overfill_then_reserved": (lambda s, m: _frame([("raw", s + m[:44]), ("reserved", b"")]), True),
    "raw_cut_past_the_strip": (lambda s, m: _frame([("cut", s + s)]), True),
    "raw_cut_inside_the_strip": (lambda s, m: _frame([("cut", s)]), False),
    "second_frame": (lambda s, m: _frame([("raw", s[:100])]) + _frame([("raw", s[100:])]), False),
    "one_pass_short": (lambda s, m: _frame([("raw", s[:-1])], content_size=len(s) - 1), False),
    "one_pass_size_mismatch": (lambda s, m: _frame([("raw", s[:150]), ("raw", s[150:] + m[:44])],
                                                    content_size=len(s)), False),
    "one_pass_exact": (lambda s, m: _frame([("raw", s[:150]), ("raw", s[150:])], content_size=len(s)), True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_end_like_libzstd(case, tmp_path):
    """libzstd's stream decoder where the strip's output ends: it flushes a
    block's bytes only after decoding it whole, goes on to the next block
    when a flush fills the output exactly, stops where a flush cannot
    complete, copies a raw block as far as its input goes, returns at a
    frame's end (libtiff then stops), and decodes a frame whose content size
    fits whole in one pass."""
    rng = np.random.default_rng(7)
    h, w = 8, 32
    strip = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
    more = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    make, reads = STREAM_CASES[case]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [50000]), 262: (3, [1]), 277: (3, [1]),
              278: (4, [h])}
    path = str(tmp_path / "s.tif")
    with open(path, "wb") as f:
        f.write(tiff_encode.tiff_file([make(strip, more)], fields))
    assert _same_as_pillow(path) == reads


@pytest.mark.parametrize("seed", range(6))
def test_random_frames_decode_to_their_source(seed):
    """Seeded random data, each option of the fixture encoder drawn at
    random, decoded straight to its source."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 70000))
    alphabet = int(rng.integers(2, 257))
    data = rng.integers(0, alphabet, n, dtype=np.int64).astype(np.uint8)
    runs = rng.integers(0, n, 5)
    for r in runs.tolist():
        data[r:r + int(rng.integers(1, 3000))] = data[r]
    frame = tiff_encode.zstd_frame(data.tobytes(), literals=str(rng.choice(["huffman", "huffman1", "raw", "rle", "treeless"])),
                                   offsets=tuple(int(v) for v in rng.integers(1, 64, 3)),
                                   block_size=int(rng.choice([100, 4096, 65536, 131072])),
                                   content_size=bool(rng.integers(2)), checksum=bool(rng.integers(2)),
                                   sequences=str(rng.choice(["predefined", "rle"])), raw_every=int(rng.integers(0, 3)))
    out = np.zeros(n, np.uint8)
    assert zstd.decode_into("random", frame, out, "frame") == n
    assert out.tobytes() == data.tobytes()
