"""JPEG 2000 frames (JP2 files and raw codestreams) read by the port
(utils/image_jpeg2000.py and csrc/jpeg2000_decode.cpp) as Pillow 12.1 reads
them through openjpeg 2.5 and as the JAX package's ``load_image`` reads
them, bitwise (tolerance 0, the 9/7 wavelet's float path included), with
and without ``size``: the committed corpus (the manifest's ``jpeg2000``),
seeded random files from Pillow's writer across its options, the syntax
Pillow's writer does not make (progression order changes, code-block
styles, ROI shifts, packed packet headers, subsampled components: the
fixture encoder's files and Pillow's files with such a field patched in),
the features still refused and the files Pillow refuses (each refusal a
ValueError naming the feature), truncated codestreams, seeded bit flips,
and the fixture encoder (data/jpeg2000_encode.py) read back by Pillow to its
source. The decoder's path counters show what the corpus covers."""

import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import CORPUS, MANIFEST, camera_like, pillow_entry, resize_sizes, sha256
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.utils import image_jpeg2000
from mlinerf_tpu_torch.utils.image_io import load_image, read_image, resize

with open(MANIFEST) as _f:
    FILES = json.load(_f)["jpeg2000"]


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


@pytest.mark.parametrize("name", sorted(FILES))
def test_jpeg2000_corpus_reads_like_jax_bitwise(name):
    """Pillow still reads each file to its manifest entry (the card's gate),
    and the port reads it to the same array and resizes, as load_image of
    the JAX package does."""
    path = os.path.join(CORPUS, name)
    entry = FILES[name]
    assert pillow_entry(path) == entry
    arr, mode = read_image(path)
    assert mode == entry["mode"] and str(arr.dtype) == entry["dtype"] and sha256(arr) == entry["sha256"]
    sizes = resize_sizes(arr.shape[1], arr.shape[0])
    for size in sizes:
        assert sha256(resize(arr, size, mode)) == entry["resized"][f"{size[0]}x{size[1]}"], size
    _assert_like_pillow_and_jax(path, sizes[:1])


def test_jpeg2000_corpus_covers_the_decoder_paths():
    """Over the corpus the decoder runs every progression order and
    progression order changes, several layers, tiles, tile-parts and
    precincts, SOP, EPH, PLT and TLM, COC and QCC, both wavelets, the RCT
    and the ICT, signed samples and offsets, subsampled components, each
    code-block style, an ROI shift, PPM and PPT; Pillow reads each of its
    modes, from both containers."""
    image_jpeg2000.counts(reset=True)
    modes, containers = set(), set()
    for name in FILES:
        _, mode = read_image(os.path.join(CORPUS, name))
        modes.add(mode)
        containers.add(os.path.splitext(name)[1])
    counts = image_jpeg2000.counts(reset=True)
    want = ("lrcp", "rlcp", "rpcl", "pcrl", "cprl", "layers", "tiles", "tile_parts", "precincts", "sop", "eph", "plt",
            "tlm", "wavelet_53", "wavelet_97", "rct", "ict", "coc", "qcc", "signed", "offset", "poc", "subsampled",
            "bypass", "reset", "termall", "causal", "pterm", "segsym", "rgn", "ppm", "ppt")
    assert not [k for k in want if not counts[k]], counts
    assert modes == {"L", "LA", "RGB", "RGBA", "I;16", "P", "CMYK"} and containers == {".jp2", ".j2k"}


def _random_file(rng):
    """A seeded random file from Pillow's writer: random size, mode and
    options among those the port decodes."""
    h, w = int(rng.integers(2, 41)), int(rng.integers(2, 41))
    mode = str(rng.choice(["L", "LA", "RGB", "RGBA", "I;16"]))
    img = camera_like(h, w, {"LA": 2, "RGB": 3, "RGBA": 4}.get(mode, 1), seed=int(rng.integers(1 << 16)))
    if mode == "I;16":
        img = (img[..., 0].astype(np.uint16) * 257 - rng.integers(0, 257, (h, w))).astype(np.uint16)
    elif mode == "L":
        img = img[..., 0]
    kw = {}
    if rng.integers(2):
        kw["irreversible"] = True
    if rng.integers(2):
        kw["mct"] = 1
    if rng.integers(2):
        kw["no_jp2"] = True
    if rng.integers(2):
        kw["progression"] = str(rng.choice(["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]))
    if rng.integers(2):
        kw["quality_layers"] = sorted((float(v) for v in rng.integers(2, 60, int(rng.integers(1, 4)))), reverse=True)
    if rng.integers(3) == 0:
        kw["codeblock_size"] = (int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7)))
    if rng.integers(3) == 0:
        kw["num_resolutions"] = int(rng.integers(1, 4))
        kw["precinct_size"] = (int(2 ** rng.integers(3, 7)),) * 2
    if rng.integers(3) == 0 and not kw.get("irreversible"):  # openjpeg's 9/7 asserts on a tile one sample wide
        kw["tile_size"] = (int(rng.integers(8, 30)), int(rng.integers(8, 30)))
    if rng.integers(4) == 0:
        kw["plt"] = True
    if mode == "L" and rng.integers(4) == 0:
        kw["signed"] = True
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue(), kw


@pytest.mark.parametrize("seed", range(8))
def test_random_pillow_files_read_like_pillow_and_jax(seed, tmp_path):
    rng = np.random.default_rng(2100 + seed)
    read = 0
    for i in range(6):
        data, kw = _random_file(rng)
        path = tmp_path / f"r{i}.{'j2k' if kw.get('no_jp2') else 'jp2'}"
        path.write_bytes(data)
        if _pillow_or_none(str(path)) is None:
            with pytest.raises(ValueError):
                read_image(str(path))
            continue
        _assert_like_pillow_and_jax(str(path), [(int(rng.integers(1, 30)), int(rng.integers(1, 30)))])
        read += 1
    assert read


def _codestream(shape=(20, 26), **kw):
    buf = io.BytesIO()
    Image.fromarray(camera_like(*shape, 3, seed=5)).save(buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


def _main_header_end(cs):
    """The offset of the first SOT."""
    pos = 2
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF90:
        pos += 2 + struct.unpack_from(">H", cs, pos + 2)[0]
    return pos


def _with_marker(cs, marker, body, in_tile=False):
    """``cs`` with a marker segment at the end of the main header or of the
    first tile-part's header (its Psot grown to match)."""
    seg = struct.pack(">HH", marker, len(body) + 2) + body
    sot = _main_header_end(cs)
    if not in_tile:
        return cs[:sot] + seg + cs[sot:]
    at = sot + 12
    cs = cs[:at] + seg + cs[at:]
    psot = struct.unpack_from(">I", cs, sot + 6)[0]
    return cs[:sot + 6] + struct.pack(">I", psot + len(seg)) + cs[sot + 10:]


def _patched(cs, marker, offset, value):
    """``cs`` with one byte of the first ``marker`` segment's body set."""
    pos = cs.index(struct.pack(">H", marker)) + 4 + offset
    return cs[:pos] + bytes([value]) + cs[pos + 1:]


def _jp2_colr(enumcs):
    buf = io.BytesIO()
    Image.fromarray(camera_like(20, 26, 3, seed=5)).save(buf, "JPEG2000")
    data = buf.getvalue()
    at = data.index(b"colr") + 7
    return data[:at] + struct.pack(">I", enumcs) + data[at + 4:]


# Files of Pillow's writer with a part-two field patched in: each reads as
# Pillow reads it (through openjpeg's code-block styles, RGN, POC or
# subsampling, decoding what the coder did not write that way).
PATCHED = {
    "codeblock_style": lambda: _patched(_codestream(), 0xFF52, 8, 0x01),
    "codeblock_style_3f": lambda: _patched(_codestream(), 0xFF52, 8, 0x3F),
    "rgn": lambda: _with_marker(_codestream(), 0xFF5E, bytes([0, 0, 3])),
    "rgn_tile": lambda: _with_marker(_codestream(), 0xFF5E, bytes([2, 0, 7]), in_tile=True),
    "poc": lambda: _with_marker(_codestream(), 0xFF5F, bytes([0, 0]) + struct.pack(">H", 1) + bytes([5, 3, 0])),
    "poc_two_changes": lambda: _with_marker(_codestream(quality_layers=[20, 5]), 0xFF5F, bytes(
        [2, 1]) + struct.pack(">H", 2) + bytes([5, 3, 4, 0, 0]) + struct.pack(">H", 1) + bytes([6, 3, 1]),
        in_tile=True),
    "subsampled": lambda: _patched(_codestream(), 0xFF51, 36 + 3 + 1, 2),
    "subsampled_chroma": lambda: _patched(_patched(_codestream(), 0xFF51, 36 + 3 + 2, 2), 0xFF51, 36 + 6 + 1, 2),
}


@pytest.mark.parametrize("case", sorted(PATCHED))
def test_patched_part_two_fields_read_like_pillow_and_jax(case, tmp_path):
    path = tmp_path / f"{case}.j2k"
    path.write_bytes(PATCHED[case]())
    _assert_like_pillow_and_jax(str(path), [(13, 10)])


def _fx(channels, container="j2k", shape=(37, 70), **kw):
    src = camera_like(*shape, channels, seed=11)
    return fixtures.encode_jpeg2000(src[..., 0] if channels == 1 else src, container, **kw)


# The fixture encoder's part-two files that are not their source (sYCC,
# subsampled components), and Pillow's cinema writers.
PART_TWO = {
    "subsampled_ycc_420": lambda: _fx(3, "jp2", ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)]),
    "subsampled_ycc_odd_width": lambda: _fx(3, "jp2", shape=(37, 71), ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)]),
    "subsampled_rgb_rpcl": lambda: _fx(3, subsampling=[(1, 1), (2, 1), (1, 2)], layers=2, progression=2),
    "subsampled_alpha": lambda: _fx(4, "jp2", subsampling=[(1, 1), (1, 1), (1, 1), (3, 2)]),
    "subsampled_everything": lambda: _fx(3, "jp2", ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)], style=0x3F,
                                         roi=[0], packed="ppt", layers=2),
    "cinema2k_24": lambda: _codestream((32, 48), cinema_mode="cinema2k-24"),
    "cinema2k_48": lambda: _codestream((32, 48), cinema_mode="cinema2k-48"),
    "cinema4k_24": lambda: _codestream((32, 48), cinema_mode="cinema4k-24"),
}


@pytest.mark.parametrize("case", sorted(PART_TWO))
def test_part_two_files_read_like_pillow_and_jax(case, tmp_path):
    path = tmp_path / f"{case}.jp2"
    path.write_bytes(PART_TWO[case]())
    _assert_like_pillow_and_jax(str(path), [(20, 9)])


def test_grey_subsampled_components_are_refused_as_pillow_refuses_them(tmp_path):
    """Pillow's grey unpackers take no subsampled component, and its decoder
    fails; the port raises naming it."""
    path = tmp_path / "grey.j2k"
    path.write_bytes(_patched(fixtures.encode_jpeg2000(camera_like(20, 26, 1, seed=5)[..., 0], "j2k"), 0xFF51, 36 + 1,
                              2))
    assert _pillow_or_none(str(path)) is None
    with pytest.raises(ValueError, match="no unpacker for subsampled components"):
        read_image(str(path))


# (file, what Pillow does, the port's message): "raises" Pillow refuses it
# too; "patched" a field is patched into a file of another coding, so only
# the port's refusal is checked.
REFUSED = {
    "htj2k_codeblocks": (lambda: _patched(_codestream(), 0xFF52, 8, 0x40), "patched",
                         r"HTJ2K code-blocks .*not ported yet \(JPEG 2000 part two\)"),
    "mixed_ht_codeblocks": (lambda: _patched(_codestream(), 0xFF52, 8, 0xC0), "raises", "mixed HT"),
    # A PPM or PPT segment of one byte (its Z alone): openjpeg refuses it.
    "ppm": (lambda: _with_marker(_codestream(), 0xFF60, bytes([0])), "raises", "PPM marker"),
    "ppt": (lambda: _with_marker(_codestream(), 0xFF61, bytes([0]), in_tile=True), "raises", "PPT marker"),
    "missing_eph": (lambda: fixtures.encode_jpeg2000(camera_like(20, 26, 3, seed=5), "j2k", eph=True).replace(
        b"\xff\x92", b"\xff\x00", 1), "raises", "EPH marker"),
    "cap": (lambda: _with_marker(_codestream(), 0xFF50, bytes(6)), "patched", r"CAP marker \(HTJ2K"),
    "htj2k_rsiz": (lambda: _patched(_codestream(), 0xFF51, 0, 0x40), "patched", r"HTJ2K \(Rsiz bit 14"),
    "mct_2": (lambda: _patched(_codestream(), 0xFF52, 4, 2), "patched", "multiple component transform"),
    "eycc": (lambda: _jp2_colr(24), "raises", "no unpacker for mode RGB from 3 components in colour space eycc"),
    # Pillow's writer at 6 resolutions: 16 x 16 precincts halve to 0 bits
    # at the lowest, and openjpeg refuses its own file.
    "precincts_too_small": (lambda: _codestream((48, 64), precinct_size=(16, 16)), "raises",
                            "invalid precinct size"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_feature(case, tmp_path):
    """Each refusal is a ValueError that names the feature: JPEG 2000 part
    two (not ported yet), or what Pillow's decoder fails on too."""
    make, pillow, message = REFUSED[case]
    path = tmp_path / f"{case}.jp2"
    path.write_bytes(make())
    if pillow == "raises":
        assert _pillow_or_none(str(path)) is None
    with pytest.raises(ValueError, match=message):
        read_image(str(path))


def test_sycc_conversion_is_pillows_for_every_input():
    """The port's YCbCr -> RGB (sYCC JP2 files) equals Pillow's
    ImagingConvertYCbCr2RGB, through Image.convert, for all 2^24 (Y, Cb,
    Cr)."""
    cb, cr = (v.astype(np.uint8) for v in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    for y in range(256):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1)
        want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        got = np.stack(image_jpeg2000._ycbcr_to_rgb(ycc[..., 0], cb, cr), -1)
        assert np.array_equal(got, want), y


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("wavelet", ["53", "97"])
def test_sycc_files_read_like_pillow_and_jax(channels, wavelet, tmp_path):
    """A JP2 whose colr box names sYCC (enumerated colour space 18): Pillow
    converts its samples from YCbCr itself."""
    buf = io.BytesIO()
    Image.fromarray(camera_like(21, 30, channels, seed=channels)).save(
        buf, "JPEG2000", **({"irreversible": True, "quality_layers": [25]} if wavelet == "97" else {}))
    data = buf.getvalue()
    at = data.index(b"colr") + 7
    path = tmp_path / "sycc.jp2"
    path.write_bytes(data[:at] + struct.pack(">I", 18) + data[at + 4:])
    _assert_like_pillow_and_jax(str(path), [(11, 17)])


@pytest.mark.parametrize("where", ["main_header", "packet_header", "packet_data", "before_eoc"])
def test_truncated_codestreams_are_refused(where, tmp_path):
    """A codestream cut short raises ValueError naming the truncation, as
    Pillow refuses it (openjpeg through Pillow: "broken data stream when
    reading image file")."""
    cs = _codestream(tile_size=(16, 16))
    sot = _main_header_end(cs)
    cut = {"main_header": sot - 3, "packet_header": sot + 15, "packet_data": len(cs) // 2,
           "before_eoc": len(cs) - 20}[where]
    path = tmp_path / "cut.j2k"
    path.write_bytes(cs[:cut])
    with pytest.raises(OSError):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match="truncated"):
        read_image(str(path))


FLIP_CASES = {"lrcp_53": {}, "layers_97_ict": dict(irreversible=True, quality_layers=[20, 5], mct=1),
              "rpcl_tiles_plt": dict(progression="RPCL", tile_size=(16, 16), plt=True),
              "cprl_precincts_j2k": dict(no_jp2=True, progression="CPRL", precinct_size=(32, 32)),
              "cinema4k_poc_j2k": dict(no_jp2=True, cinema_mode="cinema4k-24"),
              # The fixture encoder's part-two syntax (a function of the source).
              "styles_3f_layers": lambda src: fixtures.encode_jpeg2000(src, "jp2", style=0x3F, layers=2),
              "styles_lazy_termall_j2k": lambda src: fixtures.encode_jpeg2000(src, "j2k", style=0x05, mct=True),
              "poc_overlap_main": lambda src: fixtures.encode_jpeg2000(
                  src, "jp2", layers=3, poc=[[(0, 0, 2, 6, 3, 3), (2, 1, 3, 5, 3, 0), (0, 0, 3, 6, 3, 4)]],
                  poc_in="main"),
              "rgn_ppm_sop_eph": lambda src: fixtures.encode_jpeg2000(src, "j2k", roi=[0, 1], packed="ppm",
                                                                      tile_parts=2, sop=True, eph=True),
              "subsampled_ycc_ppt": lambda src: fixtures.encode_jpeg2000(
                  src, "jp2", ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)], packed="ppt", style=0x18)}


@pytest.mark.parametrize("case", sorted(FLIP_CASES))
def test_bit_flips_read_like_pillow(case, tmp_path):
    """Bits flipped through a file of Pillow's writer, half of them in its
    headers: where Pillow reads the file the port reads the same array,
    or refuses it as truncated or as part two (see ROADMAP §3); where
    Pillow fails, the port fails."""
    src = camera_like(30, 40, 3, seed=4)
    if callable(FLIP_CASES[case]):
        data = FLIP_CASES[case](src)
    else:
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "JPEG2000", **FLIP_CASES[case])
        data = buf.getvalue()
    start = data.index(b"\xff\x4f\xff\x51")
    rng = np.random.default_rng(sorted(FLIP_CASES).index(case))
    path = tmp_path / "flip.jp2"
    outcomes = set()
    for t in range(60):
        flipped = bytearray(data)
        pos = int(rng.integers(start, min(len(data), start + 300) if t % 2 else len(data)))
        flipped[pos] ^= 1 << int(rng.integers(8))
        path.write_bytes(bytes(flipped))
        want = _pillow_or_none(str(path))
        if want is None:
            with pytest.raises(ValueError):
                read_image(str(path))
        else:
            try:
                got = read_image(str(path))[0]
            except ValueError as e:
                assert "truncated" in str(e) or "part two" in str(e), (pos, e)
            else:
                assert np.array_equal(got, want), pos
        outcomes.add(want is None)
    assert outcomes == {False, True}


ENCODER_CASES = {
    "rgb_mct_jp2": (3, dict(container="jp2", mct=True)),
    "rgb_j2k": (3, dict(container="j2k")),
    "grey_jp2": (1, dict(container="jp2")),
    "rgba_sop_eph": (4, dict(container="jp2", sop=True, eph=True)),
    "rgb_tile_parts_tlm": (3, dict(container="j2k", mct=True, tile_parts=4, tlm=True)),
    "rgba_coc_qcc": (4, dict(container="jp2", mct=True, coc=True, qcc=True)),
    "grey_coc": (1, dict(container="j2k", coc=True)),
    **{f"style_{bit:02x}": (3, dict(container="j2k", mct=True, style=bit)) for bit in (1, 2, 4, 8, 16, 32, 0x3F)},
    "style_lazy_termall_grey": (1, dict(container="jp2", style=0x05)),
    "layers_3": (4, dict(container="jp2", layers=3)),
    "poc_cinema4k": (3, dict(container="j2k", progression=4, poc=fixtures.jpeg2000_encode.CINEMA4K_POC)),
    "poc_main_two_markers": (3, dict(container="j2k", layers=2, poc_in="main",
                                     poc=[[(0, 0, 1, 3, 2, 0), (1, 1, 2, 4, 3, 1)], [(0, 0, 2, 6, 3, 2)]])),
    "rgn": (3, dict(container="jp2", mct=True, roi=[0, 2])),
    "rgn_lazy": (1, dict(container="j2k", roi=[0], style=0x11)),
    "ppm_across_tile_parts": (3, dict(container="j2k", packed="ppm", tile_parts=3, eph=True, packed_size=40)),
    "ppt_sop": (4, dict(container="jp2", packed="ppt", tile_parts=2, sop=True, layers=2, packed_size=50)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_fixture_encoder_reads_back_by_pillow(case, tmp_path):
    """The fixture encoder's frames are lossless: Pillow reads each back to
    its source, and the port reads it as Pillow does."""
    channels, kw = ENCODER_CASES[case]
    src = camera_like(37, 70, channels, seed=11)
    src = src[..., 0] if channels == 1 else src
    path = tmp_path / f"{case}.{kw['container']}"
    path.write_bytes(fixtures.encode_jpeg2000(src, **kw))
    got, _ = _pillow(str(path))
    assert np.array_equal(got, src.reshape(got.shape))
    _assert_like_pillow_and_jax(str(path), [(20, 9)])
