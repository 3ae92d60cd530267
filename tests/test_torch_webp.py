"""The port's WebP reader (mlinerf_tpu_torch/utils/image_webp.py, with
csrc/webp_decode.cpp) against Pillow 12.1 (libwebp 1.6.0) and the JAX
package's ``load_image``, bitwise (tolerance 0: uint8 arrays equal, and
``load_image``'s float32 equal), raw and at each resize: every WebP file of
the committed corpus (the manifest's ``webp`` key and the timed frames);
seeded random frames written by Pillow (lossy at several qualities and
methods, with alpha at alpha qualities below 100, lossless with 2, 4, 16
and many colours, two-frame animations) at sizes from 1x1 to odd sizes
past one macroblock; and every malformed file Pillow refuses, refused by a
ValueError that names what is wrong."""

import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import CORPUS, MANIFEST, camera_like, resize_sizes, sha256
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures, webp_encode
from mlinerf_tpu_torch.utils import image_webp
from mlinerf_tpu_torch.utils.image_io import load_image, read_image, resize

with open(MANIFEST) as _f:
    _MANIFEST = json.load(_f)
WEBP = dict(_MANIFEST["webp"])
WEBP.update({e["file"]: {k: v for k, v in e.items() if k != "file"} for c, e in _MANIFEST["timed"].items()
             if c.startswith("webp")})
SIZES = [(1, 1), (1, 7), (5, 1), (16, 16), (17, 33), (31, 18), (45, 29)]


def _assert_like_pillow_and_jax(path, sizes):
    got, mode = read_image(path)
    with Image.open(path) as im:
        want, want_mode = np.asarray(im), im.mode
    assert mode == want_mode and got.dtype == want.dtype == np.uint8 and got.shape == want.shape, (mode, want_mode)
    assert np.array_equal(got, want), path
    for size in [None, *sizes]:
        a, b = load_image(path, size), jax_load_image(path, size)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (size, a.shape, b.shape)
        assert np.array_equal(a, b), (path, size)


@pytest.mark.parametrize("name", sorted(WEBP))
def test_webp_corpus_reads_like_jax_bitwise(name):
    path = os.path.join(CORPUS, name)
    entry = WEBP[name]
    arr, mode = read_image(path)
    assert mode == entry["mode"] and list(arr.shape) == entry["shape"] and sha256(arr) == entry["sha256"]
    sizes = resize_sizes(arr.shape[1], arr.shape[0])
    for size in sizes:
        assert sha256(resize(arr, size, mode)) == entry["resized"][f"{size[0]}x{size[1]}"], size
    _assert_like_pillow_and_jax(path, sizes)


def test_webp_corpus_is_small_and_complete():
    """The WebP files stay under 40,000 bytes beside the timed frames; they
    hold every bitstream and container form the reader decodes."""
    small = [n for n in _MANIFEST["webp"]]
    assert sum(os.path.getsize(os.path.join(CORPUS, n)) for n in small) < 40_000
    forms = set()
    for name in WEBP:
        with open(os.path.join(CORPUS, name), "rb") as f:
            data = f.read()
        pos = 12
        while pos + 8 <= len(data):
            tag, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
            forms.add(tag)
            if tag == b"ALPH":
                forms.add(("alpha", data[pos + 8] & 3, (data[pos + 8] >> 2) & 3))
            pos += 8 + size + (size & 1) if tag != b"ANMF" else 24
    assert {b"VP8 ", b"VP8L", b"VP8X", b"ALPH", b"ANIM", b"ANMF", b"ICCP", b"EXIF", b"XMP "} <= forms
    assert {("alpha", 0, 3), ("alpha", 1, 1), ("alpha", 1, 2)} <= forms  # raw and coded, each filter
    assert {e["mode"] for e in WEBP.values()} == {"RGB", "RGBA"}


def _pillow_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_lossy_frames_read_like_jax_bitwise(size, tmp_path):
    """libwebp's lossy coder at quality 0-100 and methods 0-6, RGB and
    RGBA (alpha quality 100 and below)."""
    h, w = size
    rng = np.random.default_rng(h * 100 + w)
    for k, (quality, method) in enumerate(((0, 0), (35, 3), (75, 4), (100, 6))):
        img = camera_like(h, w, 4, seed=int(rng.integers(1 << 16)))
        path = str(tmp_path / f"q{quality}.webp")
        with open(path, "wb") as f:
            f.write(_pillow_bytes(img[..., :3], quality=quality, method=method))
        _assert_like_pillow_and_jax(path, [(w + 5, 2 * h + 1), (max(1, w // 2), max(1, h // 3))])
        with open(path, "wb") as f:
            f.write(_pillow_bytes(img, quality=quality, method=method, alpha_quality=(100, 60, 20, 0)[k]))
        _assert_like_pillow_and_jax(path, [(w + 3, h + 2)])


@pytest.mark.parametrize("colours", [2, 4, 16, 200, None], ids=lambda c: f"colours{c}")
def test_pillow_lossless_frames_read_like_jax_bitwise(colours, tmp_path):
    """Colour indexing at 2, 4 and 16 colours (1-, 2- and 4-bit bundles,
    widths that do not divide by the bundle) and 200; many colours; each
    read back to its source (``exact``: libwebp keeps the colour of
    transparent pixels)."""
    rng = np.random.default_rng(colours or 0)
    for h, w in SIZES:
        for c in (3, 4):
            img = camera_like(h, w, c, seed=int(rng.integers(1 << 16)))
            if colours:
                img = rng.integers(0, 256, (colours, c), dtype=np.uint8)[rng.integers(0, colours, (h, w))]
            path = str(tmp_path / f"l{h}x{w}_{c}.webp")
            with open(path, "wb") as f:
                f.write(_pillow_bytes(img, lossless=True, exact=True, method=int(rng.integers(0, 7)),
                                      quality=int(rng.integers(0, 101))))
            _assert_like_pillow_and_jax(path, [(w + 2, h + 3)])
            assert np.array_equal(read_image(path)[0], img)


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
def test_pillow_animations_read_frame_0(lossless, tmp_path):
    rng = np.random.default_rng(int(lossless))
    for h, w in ((7, 9), (20, 35)):
        frames = [Image.fromarray(camera_like(h, w, 4, seed=int(rng.integers(1 << 16))), "RGBA") for _ in range(2)]
        path = str(tmp_path / f"a{h}x{w}.webp")
        frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:], duration=50, lossless=lossless)
        with Image.open(path) as im:
            assert im.n_frames == 2
        _assert_like_pillow_and_jax(path, [(w * 2, h + 1)])


def _malformed():
    """{what: bytes} of files Pillow refuses, and the words of each refusal."""
    img = camera_like(20, 30, 4, seed=3)
    vp8 = webp_encode.encode_vp8(img[..., :3], quality=60, partitions=4, seed=1)
    vp8l = webp_encode.encode_vp8l(img)
    alph = webp_encode.encode_alph(img[..., 3])
    chunk, riff, vp8x = webp_encode.chunk, webp_encode.riff, webp_encode.vp8x
    first = (vp8[0] | vp8[1] << 8 | vp8[2] << 16) >> 5

    def edit(data, pos, value):
        out = bytearray(data)
        out[pos] = value
        return bytes(out)

    good = riff([chunk(b"VP8 ", vp8)])
    anim = fixtures.encode_webp(img[..., :3], canvas=(40, 30), offset=(10, 10))
    at = anim.find(b"ANMF") + 8
    return {
        "truncated file": (good[:len(good) // 2], "truncated file"),
        "chunk past the RIFF": (good[:12] + b"VP8 " + struct.pack("<I", len(vp8) + 100) + vp8, "runs past the RIFF"),
        "interframe": (riff([chunk(b"VP8 ", edit(vp8, 0, vp8[0] | 1))]), "interframe"),
        "hidden frame": (riff([chunk(b"VP8 ", edit(vp8, 0, vp8[0] & ~0x10))]), "not to be shown"),
        "profile 4": (riff([chunk(b"VP8 ", edit(vp8, 0, vp8[0] | 0x08))]), "profile 4"),
        "start code": (riff([chunk(b"VP8 ", edit(vp8, 3, 0x9C))]), "start code"),
        "first partition past the chunk": (riff([chunk(b"VP8 ", edit(edit(vp8, 1, 0xFF), 2, 0xFF))]),
                                           "first partition"),
        "partition sizes cut": (riff([chunk(b"VP8 ", vp8[:10 + first + 4])]), "partitions"),
        "last partition empty": (riff([chunk(b"VP8 ", vp8[:10 + first + 9])]), "partitions"),
        "token data cut": (riff([chunk(b"VP8 ", webp_encode.encode_vp8(img[..., :3], seed=2)[:-40])]),
                           "premature end"),
        "no image chunk": (riff([vp8x(0x10, 30, 20), chunk(b"ALPH", alph)]), "no image chunk"),
        "only metadata": (riff([vp8x(0x20, 30, 20), chunk(b"ICCP", bytes(8))]), "no image chunk"),
        "VP8L version": (riff([chunk(b"VP8L", edit(vp8l, 4, vp8l[4] | 0x20))]), "version bits"),
        "VP8L signature": (riff([chunk(b"VP8L", edit(vp8l, 0, 0x2E))]), "signature"),
        "VP8L data cut": (riff([chunk(b"VP8L", vp8l[:len(vp8l) // 2])]), "truncated"),
        "ALPH before VP8L": (riff([vp8x(0x10, 30, 20), chunk(b"ALPH", alph), chunk(b"VP8L", vp8l)]),
                             "carries its own alpha"),
        "canvas size": (riff([vp8x(0, 31, 20), chunk(b"VP8 ", vp8)]), "canvas"),
        "unknown VP8X flag": (riff([vp8x(0x01, 30, 20), chunk(b"VP8 ", vp8)]), "flags"),
        "second VP8X": (riff([vp8x(0, 30, 20), vp8x(0, 30, 20), chunk(b"VP8 ", vp8)]), "second VP8X"),
        "ALPH compression 2": (riff([vp8x(0x10, 30, 20), chunk(b"ALPH", bytes([2]) + alph[1:]), chunk(b"VP8 ", vp8)]),
                               "compression 2"),
        "ALPH reserved bits": (riff([vp8x(0x10, 30, 20), chunk(b"ALPH", bytes([alph[0] | 0x40]) + alph[1:]),
                                     chunk(b"VP8 ", vp8)]), "reserved bits 1"),
        "raw ALPH short": (riff([vp8x(0x10, 30, 20), chunk(b"ALPH", bytes(101)), chunk(b"VP8 ", vp8)]),
                           "shorter than the image"),
        "frame outside canvas": (anim[:at] + (8).to_bytes(3, "little") + anim[at + 3:], "outside the 40x30 canvas"),
        "image outside ANMF": (riff([vp8x(0x02, 30, 20), chunk(b"ANIM", bytes(6)), chunk(b"VP8 ", vp8)]),
                               "outside an ANMF"),
        "ANMF before ANIM": (anim.replace(b"ANIM", b"ANIZ"), "ANMF before ANIM"),
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("what", sorted(MALFORMED))
def test_refusals_name_the_feature(what, tmp_path):
    data, words = MALFORMED[what]
    path = tmp_path / "bad.webp"
    path.write_bytes(data)
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match=words):
        read_image(str(path))


@pytest.mark.parametrize("source", ["libwebp_lossy", "libwebp_lossless", "fixture_lossy", "fixture_lossless"])
def test_truncation_fails_where_pillow_fails(source, tmp_path):
    """The payload cut 0-40 bytes short (the RIFF sizes made to fit): the
    port reads it exactly when Pillow does, the same array, and refuses it
    otherwise. libwebp's bit readers run past a short stream by rules of
    their own (VP8: a byte beyond a partition's end; VP8L: a bit beyond the
    data), which these cuts cross."""
    img = camera_like(24, 40, 4, seed=12)
    if source.startswith("libwebp"):
        data = _pillow_bytes(img if source.endswith("lossless") else img[..., :3],
                             **({"lossless": True} if source.endswith("lossless") else {"quality": 80}))
        tag, payload = data[12:16], data[20:20 + struct.unpack_from("<I", data, 16)[0]]
    else:
        lossless = source.endswith("lossless")
        tag = b"VP8L" if lossless else b"VP8 "
        payload = webp_encode.encode_vp8l(img) if lossless else webp_encode.encode_vp8(img[..., :3], quality=80)
    path = tmp_path / "cut.webp"
    read = []
    for k in range(41):
        path.write_bytes(webp_encode.riff([webp_encode.chunk(tag, payload[:len(payload) - k])]))
        try:
            with Image.open(path) as im:
                want = np.asarray(im)
        except OSError:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                read_image(str(path))
        else:
            assert np.array_equal(read_image(str(path))[0], want), k
        read.append(want is not None)
    assert read[0] and not read[-1]


def test_signature_needs_a_webp_form(tmp_path):
    """RIFF files that are not WebP to Pillow (another form at 12-16, or not
    WEBP at 8-12) are not WebP to the port either."""
    assert image_webp.is_webp(b"RIFF\x00\x00\x00\x00WEBPVP8L") and not image_webp.is_webp(b"RIFF\x00\x00\x00\x00WEBPVP9 ")
    for data in (b"RIFF" + struct.pack("<I", 12) + b"WEBPVP9 " + bytes(8), b"RIFF" + struct.pack("<I", 12) + b"WAVEfmt "
                 + bytes(8)):
        path = tmp_path / "x.webp"
        path.write_bytes(data)
        with pytest.raises(Exception):
            Image.open(path)
        with pytest.raises(ValueError, match="not a PNG, JPEG, TIFF, BMP, WebP or JPEG 2000 file"):
            read_image(str(path))
