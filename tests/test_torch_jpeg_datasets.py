"""The port's loaders on JPEG captures against the JAX package's (Pillow)
loaders, at TINY sizes: ``nerf_llff`` on a fern-layout stand-in whose frames
are ``IMG_<i>.JPG`` (4:2:0, as a phone writes them) and NRHints'
``lumen_blender`` with ``file_ext: .jpg``, each split at the raw size and
resized; then the same layouts with their frames in turn lossless,
arithmetic-coded (sequential and progressive) and progressive with bands
left unrefined (which libjpeg smooths). Images are bitwise equal (uint8),
intrinsics and poses within POSE_TOL (the loaders' float32 arithmetic is the
same; the bound only allows for it)."""

import itertools
import os

import numpy as np
import pytest

from torch_parity import TINY_FILES, dataset_args

from mlinerf_tpu.config import Config as JaxConfig
from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures

POSE_TOL = 1e-6
LLFF = "configs/nerf_llff.yaml"
PIKACHU = "configs/NRHints_Pikachu_a.yaml"


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """fern's layout at 96x72 raw (9 JPEG views: 7 train, 2 val) and NRHints'
    at 24x24 (4 train, 2 val JPEG frames)."""
    root = tmp_path_factory.mktemp("jpeg_scenes")
    fixtures.write_llff(str(root / "fern"), raw_size=(96, 72), render_div=2, image_format="jpeg")
    nrh = fixtures.write_point_light(str(root / "nrh"), image_size=24, train=4, val=2, source="nrhints",
                                     image_format="jpeg")
    return {LLFF: str(root / "fern"), PIKACHU: (str(root / "nrh"), nrh)}


# The codings the frames of ``coded_scenes`` take in turn.
CODINGS = {
    "lossless": lambda img, i: fixtures.encode_jpeg_lossless(img, predictor=1 + i % 7, restart_interval=img.shape[1]),
    "arithmetic": lambda img, i: fixtures.encode_jpeg_dct(img, 90, coding="arithmetic"),
    "arithmetic_progressive": lambda img, i: fixtures.encode_jpeg_dct(img, 90, coding="arithmetic",
                                                                      scans=fixtures.progressive_scans(3)),
    "smoothed": lambda img, i: fixtures.encode_jpeg_dct(img, 90, scans=fixtures.progressive_scans(3)[:6]),
}


def coding_saver():
    """``save(path, img)`` writing each frame in the next of CODINGS."""
    count = itertools.count()

    def save(path, img):
        i = next(count)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(list(CODINGS.values())[i % len(CODINGS)](img, i))

    return save


@pytest.fixture(scope="module")
def coded_scenes(tmp_path_factory):
    """The scenes of ``scenes``, their frames written by coding_saver."""
    root = tmp_path_factory.mktemp("jpeg_coded_scenes")
    fixtures.write_llff(str(root / "fern"), raw_size=(96, 72), render_div=2, image_format="jpeg",
                        save=coding_saver())
    nrh = fixtures.write_point_light(str(root / "nrh"), image_size=24, train=4, val=2, source="nrhints",
                                     image_format="jpeg", save=coding_saver())
    return {LLFF: str(root / "fern"), PIKACHU: (str(root / "nrh"), nrh)}


def _datasets(scenes, config, size, is_inference):
    if config == LLFF:
        args = [f"--data.root={scenes[LLFF]}", f"--data.train.image_size=[{size[0]},{size[1]}]",
                f"--data.val.image_size=[{size[0]},{size[1]}]"]
    else:
        root, annotations = scenes[PIKACHU]
        args = TINY_FILES + dataset_args(root, annotations, size)
    jcfg, tcfg = JaxConfig(config, cli_args=args), Config(config, cli_args=args)
    return (jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=is_inference),
            resolve("dataset", tcfg.data.type)(tcfg, is_inference=is_inference))


SIZES = {LLFF: {"raw": (72, 96), "resized": (36, 48)}, PIKACHU: {"raw": (24, 24), "resized": (10, 10)}}


def test_stand_ins_are_jpeg(scenes):
    import glob
    import json
    import os

    frames = sorted(glob.glob(os.path.join(scenes[LLFF], "images", "*")))
    assert len(frames) == 9 and all(f.endswith(".JPG") for f in frames)
    assert all(open(f, "rb").read(3) == b"\xff\xd8\xff" for f in frames)
    root, annotations = scenes[PIKACHU]
    meta = json.load(open(annotations["train"]))
    assert {fr["file_ext"] for fr in meta["frames"]} == {".jpg"}
    with pytest.raises(ValueError, match="source='nrhints'"):
        fixtures.write_point_light(os.path.join(root, "mli"), image_size=8, image_format="jpeg")


def test_coded_stand_ins_take_every_coding(coded_scenes):
    import glob

    from make_torch_image_corpus import jpeg_frame

    frames = sorted(glob.glob(os.path.join(coded_scenes[LLFF], "images", "*.JPG")))
    sofs = [jpeg_frame(open(f, "rb").read())[0] for f in frames]
    assert sofs[:4] == ["SOF3", "SOF9", "SOF10", "SOF2"] and len(frames) == 9


def _assert_match(scenes, config, size, split):
    jds, tds = _datasets(scenes, config, SIZES[config][size], is_inference=split == "val")
    want, got = jds.as_arrays(), tds.as_arrays()
    assert sorted(got) == sorted(want) and len(tds) == len(jds)
    assert got["images"].dtype == want["images"].dtype == np.uint8
    assert got["images"].shape[1:3] == SIZES[config][size]
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key == "images":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=POSE_TOL, err_msg=key)
    assert 0 < got["images"].mean() < 255


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
@pytest.mark.parametrize("config", [LLFF, PIKACHU], ids=["nerf_llff", "nrhints"])
def test_jpeg_captures_match_jax(scenes, config, size, split):
    _assert_match(scenes, config, size, split)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
@pytest.mark.parametrize("config", [LLFF, PIKACHU], ids=["nerf_llff", "nrhints"])
def test_jpeg_coded_captures_match_jax(coded_scenes, config, size, split):
    _assert_match(coded_scenes, config, size, split)
