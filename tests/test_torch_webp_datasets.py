"""The port's NRHints (``lumen_blender``) and ReNe (``lumen``) loaders on
captures whose frames are WebP, against the JAX package's (Pillow)
loaders, at TINY sizes: NRHints' train frames in turn lossy WebP, lossy
with an alpha plane and lossless, its val frames lossy; ReNe's frames
alternately lossy and lossless under ``.webp`` file paths; each split at
the raw size and resized. Images are bitwise equal (uint8), intrinsics and
poses within POSE_TOL (the loaders' float32 arithmetic is the same; the
bound only allows for it)."""

import json
import os

import numpy as np
import pytest

from torch_parity import TINY_FILES, dataset_args

from mlinerf_tpu.config import Config as JaxConfig
from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures

POSE_TOL = 1e-6
PIKACHU = "configs/NRHints_Pikachu_a.yaml"
SAVANNAH = "configs/rene_savannah_a.yaml"
TRAIN_FORMATS = ["webp", "webp_alpha", "webp_lossless"]
SIZES = {"raw": (24, 24), "resized": (10, 10)}
RENE_RAW = (36, 27)  # (W, H)
RENE_SIZES = {"raw": (27, 36), "resized": (12, 16)}


@pytest.fixture(scope="module")
def nrhints(tmp_path_factory):
    """NRHints' layout at 24x24: 3 train frames, one in each of
    TRAIN_FORMATS, and 2 lossy val frames."""
    root = str(tmp_path_factory.mktemp("webp_scene") / "nrh")
    annotations = fixtures.write_point_light(root, image_size=24, train=3, val=2, source="nrhints",
                                             image_format={"train": TRAIN_FORMATS, "val": "webp"})
    return root, annotations


@pytest.fixture(scope="module")
def rene(tmp_path_factory):
    """ReNe's layout at 36x27 (2 cameras x 2 lights), its frames WebP,
    the annotations' file paths renamed to ``.webp``."""
    root = str(tmp_path_factory.mktemp("webp_rene") / "rene")
    count = [0]

    def save(path, img):
        fmt = ("webp", "webp_lossless")[count[0] % 2]
        count[0] += 1
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(os.path.splitext(path)[0] + ".webp", "wb") as f:
            f.write(fixtures.FRAME_FORMATS[fmt][1](img))

    annotations = fixtures.write_rene(root, "dataset_rene/savannah", cameras=2, lights=2, raw_size=RENE_RAW, save=save)
    for path in annotations.values():
        with open(path) as f:
            meta = json.load(f)
        for frame in meta["frames"]:
            frame["file_path"] = os.path.splitext(frame["file_path"])[0] + ".webp"
        with open(path, "w") as f:
            json.dump(meta, f)
    return root, annotations


def test_stand_in_frames_are_webp(nrhints):
    root, annotations = nrhints
    for split in ("train", "val"):
        for fr in json.load(open(annotations[split]))["frames"]:
            assert fr["file_ext"] == ".webp"
            head = open(os.path.join(root, fr["file_path"] + fr["file_ext"]), "rb").read(16)
            assert head[:4] == b"RIFF" and head[8:12] == b"WEBP" and head[12:16] in (b"VP8 ", b"VP8X", b"VP8L")


def _compare(config, root, annotations, size, is_inference):
    args = TINY_FILES + dataset_args(root, annotations, size)
    jcfg, tcfg = JaxConfig(config, cli_args=args), Config(config, cli_args=args)
    jds = jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=is_inference)
    tds = resolve("dataset", tcfg.data.type)(tcfg, is_inference=is_inference)
    want, got = jds.as_arrays(), tds.as_arrays()
    assert sorted(got) == sorted(want) and len(tds) == len(jds)
    assert got["images"].dtype == want["images"].dtype == np.uint8
    assert got["images"].shape[1:3] == tuple(size)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key == "images":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=POSE_TOL, err_msg=key)
    assert 0 < got["images"].mean() < 255


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
def test_webp_nrhints_capture_matches_jax(nrhints, size, split):
    _compare(PIKACHU, *nrhints, SIZES[size], is_inference=split == "val")


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
def test_webp_rene_capture_matches_jax(rene, size, split):
    _compare(SAVANNAH, *rene, RENE_SIZES[size], is_inference=split == "val")
