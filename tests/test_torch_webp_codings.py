"""The WebP codings Pillow cannot ask libwebp for, written by the fixtures'
encoders (mlinerf_tpu_torch/data/webp_encode.py, ``fixtures.encode_webp``),
read by the port as Pillow 12.1 (libwebp 1.6.0) and the JAX package's
``load_image`` read them, bitwise (tolerance 0), raw and resized: VP8 with
the simple and the normal loop filter at each sharpness, 1, 2, 4 and 8
token partitions, 1-4 segments, loop-filter deltas, updated token
probabilities, 16x16 and B_PRED macroblocks with every 4x4 mode, with and
without the skip flag; VP8L with each transform alone and together, in
several orders, the colour cache, backward references and meta prefix
codes; ALPH raw and VP8L-coded under each filter; frame 0 of an animation
at an offset inside a larger canvas; VP8X files with metadata and unknown
chunks; and every FRAME_FORMATS WebP coding. The lossless codings and raw
alpha read back to their source exactly."""

import numpy as np
import pytest
from PIL import Image

from make_torch_image_corpus import camera_like
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.data import fixtures, webp_encode
from mlinerf_tpu_torch.utils.image_io import load_image, read_image

SIZES = [(1, 1), (3, 2), (16, 16), (19, 37), (33, 17)]


def _check(tmp_path, data, sizes=()):
    """Writes the file; the port's array equals Pillow's and load_image the
    JAX package's at each size. Returns the array."""
    path = str(tmp_path / "f.webp")
    with open(path, "wb") as f:
        f.write(data)
    got, mode = read_image(path)
    with Image.open(path) as im:
        want = np.asarray(im)
        assert im.mode == mode and want.shape == got.shape and np.array_equal(got, want), (im.mode, mode)
    for size in [None, *sizes]:
        a, b = load_image(path, size), jax_load_image(path, size)
        assert a.shape == b.shape and np.array_equal(a, b), size
    return got


VP8_CASES = {
    "normal_filter": dict(filter="normal", quality=50),
    "simple_filter": dict(filter="simple", quality=30),
    "no_filter": dict(filter="none", quality=90),
    "sharpness": dict(sharpness=7, quality=20, level=40),
    "sharpness3_simple": dict(sharpness=3, filter="simple", level=63),
    "partitions2": dict(partitions=2),
    "partitions4": dict(partitions=4, quality=95),
    "partitions8": dict(partitions=8, intra="bpred"),
    "segments": dict(segments=4, quality=40),
    "segments2_deltas": dict(segments=2, lf_delta=(-3, 9)),
    "lf_deltas": dict(lf_delta=(5, -20), level=30),
    "prob_updates": dict(prob_updates=40, quality=80),
    "bpred_best": dict(intra="bpred"),
    "bpred_random": dict(intra="bpred", bpred_modes="random", quality=60),
    "i16": dict(intra="i16", quality=10),
    "no_skip_flag": dict(skip_proba=False, quality=5),
}


@pytest.mark.parametrize("case", sorted(VP8_CASES))
def test_vp8_codings_read_like_jax_bitwise(case, tmp_path):
    rng = np.random.default_rng(len(case))
    for k, (h, w) in enumerate(SIZES):
        img = camera_like(h, w, 3, seed=int(rng.integers(1 << 16)))
        data = fixtures.encode_webp(img, seed=k, **VP8_CASES[case])
        _check(tmp_path, data, [(w + 5, h + 9)])


def test_bpred_modes_and_contexts_all_occur():
    """The B_PRED cases code every 4x4 mode, at the frame's top and left
    edges and inside it."""
    frame = webp_encode._VP8Frame(camera_like(64, 80, 3, seed=5), 40, 1, "bpred", 1.0, "random",
                                  np.random.default_rng(0))
    modes = np.concatenate([mb["modes"] for mb in frame.mbs])
    assert set(modes.tolist()) == set(range(10))


VP8L_CASES = {
    "none": dict(transforms=()),
    "subtract_green": dict(transforms=("subtract_green",)),
    "predictor_best": dict(transforms=("predictor",), transform_bits=2),
    "predictor_every_mode": dict(transforms=("predictor",), transform_bits=2, predictor_modes=list(range(16))),
    "cross_color": dict(transforms=("cross_color",), transform_bits=3),
    "all_three": dict(transforms=("subtract_green", "predictor", "cross_color"), transform_bits=4),
    "reversed": dict(transforms=("cross_color", "predictor", "subtract_green"), predictor_modes="random"),
    "cache": dict(cache_bits=1),
    "cache11": dict(cache_bits=11, transforms=("predictor",)),
    "no_backrefs": dict(backrefs=False),
    "meta_codes": dict(meta_bits=2, groups=4),
    "meta_cache": dict(meta_bits=3, groups=2, cache_bits=5),
}
PALETTE_CASES = {2: {}, 3: {}, 4: dict(transforms=("palette", "predictor")), 11: dict(shuffle_palette=True),
                 16: dict(cache_bits=4), 17: dict(transforms=("palette", "subtract_green")), 256: {}}


@pytest.mark.parametrize("case", sorted(VP8L_CASES))
def test_vp8l_codings_round_trip_like_jax(case, tmp_path):
    rng = np.random.default_rng(len(case) + 100)
    for k, (h, w) in enumerate(SIZES):
        for c in (3, 4):
            img = camera_like(h, w, c, seed=int(rng.integers(1 << 16)))
            if k == 3:  # runs for the backward references
                img[:, w // 3:] = img[:, w // 3:w // 3 + 1]
            got = _check(tmp_path, fixtures.encode_webp(img, lossless=True, seed=k, **VP8L_CASES[case]),
                         [(w + 1, 2 * h)])
            assert np.array_equal(got, img)


@pytest.mark.parametrize("colours", sorted(PALETTE_CASES))
def test_colour_indexing_round_trips_like_jax(colours, tmp_path):
    """1-, 2-, 4- and 8-bit indices, widths the bundle does not divide."""
    rng = np.random.default_rng(colours)
    for k, (h, w) in enumerate(SIZES):
        palette = rng.integers(0, 256, (colours, 4), dtype=np.uint8)
        img = palette[rng.integers(0, colours, (h, w))]
        opts = {"transforms": ("palette",), **PALETTE_CASES[colours]}
        got = _check(tmp_path, fixtures.encode_webp(img, lossless=True, seed=k, **opts), [(w + 2, h)])
        assert np.array_equal(got, img)


@pytest.mark.parametrize("compression", ["raw", "lossless"])
@pytest.mark.parametrize("filt", sorted(webp_encode.ALPHA_FILTERS))
def test_alpha_codings_read_like_jax(compression, filt, tmp_path):
    """ALPH under each filter; its plane reads back to the source exactly,
    with and without the pre-processing flag (which costs nothing at
    Pillow's alpha dithering of 0)."""
    rng = np.random.default_rng(7)
    for k, (h, w) in enumerate(SIZES):
        img = camera_like(h, w, 4, seed=int(rng.integers(1 << 16)))
        data = fixtures.encode_webp(img, alpha=compression, alpha_filter=filt, alpha_pre_processing=k % 2,
                                    alpha_options=dict(cache_bits=2) if k == 2 else None, quality=70, seed=k)
        got = _check(tmp_path, data, [(w + 3, h + 1)])
        assert got.shape[-1] == 4 and np.array_equal(got[..., 3], img[..., 3])


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
@pytest.mark.parametrize("channels", [3, 4])
def test_animation_frame_0_at_an_offset(lossless, channels, tmp_path):
    """Frame 0 smaller than the canvas, placed at its offset on a zeroed
    canvas; the mode is RGBA where the VP8X flag says alpha."""
    rng = np.random.default_rng(channels)
    for h, w, canvas, offset in ((5, 7, (9, 8), (2, 2)), (19, 37, (60, 41), (10, 20)), (16, 16, (16, 16), (0, 0))):
        img = camera_like(h, w, channels, seed=int(rng.integers(1 << 16)))
        data = fixtures.encode_webp(img, lossless=lossless, canvas=canvas, offset=offset)
        got = _check(tmp_path, data, [(canvas[0] // 2, canvas[1] + 3)])
        assert got.shape == (canvas[1], canvas[0], channels)
        x, y = offset
        outside = np.ones(got.shape[:2], bool)
        outside[y:y + h, x:x + w] = False
        assert not got[outside].any()
        if lossless:
            assert np.array_equal(got[y:y + h, x:x + w], img)


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
def test_vp8x_metadata_and_unknown_chunks_are_skipped(lossless, tmp_path):
    img = camera_like(13, 21, 3, seed=9)
    plain = _check(tmp_path, fixtures.encode_webp(img, lossless=lossless))
    for kw in (dict(vp8x=True), dict(metadata=True), dict(unknown_chunk=True), dict(metadata=True, unknown_chunk=True)):
        assert np.array_equal(_check(tmp_path, fixtures.encode_webp(img, lossless=lossless, **kw), [(7, 7)]), plain)


@pytest.mark.parametrize("fmt", [f for f, (ext, _) in sorted(fixtures.FRAME_FORMATS.items()) if ext == ".webp"])
def test_frame_format_codings_read_like_jax(fmt, tmp_path):
    img = fixtures.camera_frame(4, (61, 35))
    got = _check(tmp_path, fixtures.FRAME_FORMATS[fmt][1](img), [(30, 20)])
    if fmt in fixtures.LOSSY_FORMATS:
        assert np.abs(got[..., :3].astype(np.int64) - img).mean() < 6
    else:
        assert np.array_equal(got, img)


def test_round_trips_of_lossless_and_raw_alpha():
    """encode_webp's lossless codings and raw alpha give back their source
    through the port's reader alone (no Pillow), at a size past several
    tiles and macroblocks."""
    import tempfile

    img = camera_like(70, 53, 4, seed=11)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/r.webp"
        for data in (fixtures.encode_webp(img, lossless=True, cache_bits=7, meta_bits=3),
                     fixtures.encode_webp(img, lossless=True, transforms=("predictor",), predictor_modes="random"),
                     fixtures.encode_webp(img[..., :3], lossless=True)):
            with open(path, "wb") as f:
                f.write(data)
            arr, mode = read_image(path)
            assert np.array_equal(arr, img[..., :arr.shape[-1]])
        for filt in webp_encode.ALPHA_FILTERS:
            with open(path, "wb") as f:
                f.write(fixtures.encode_webp(img, alpha="raw", alpha_filter=filt))
            arr, mode = read_image(path)
            assert mode == "RGBA" and np.array_equal(arr[..., 3], img[..., 3])
