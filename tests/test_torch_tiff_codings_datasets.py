"""The port's NRHints loader (``lumen_blender``) on a capture whose frames
are TIFFs in libtiff's other codecs, against the JAX package's (Pillow)
loader, at TINY sizes: the train frames in turn JPEG-compressed YCbCr 4:2:0
and RGB, YCbCr 2x2 under LZW (libtiff's RGBA path), Zstandard RGB with
predictor 2 and LZMA 16-bit RGBA (big-endian, predictor 2), the val frames
Zstandard; and a second capture whose train frames are JP2 (5/3 with the
RCT), raw JPEG 2000 codestreams and old-style JPEG TIFFs, its val frames
JP2; each split at the raw size and resized. Images are bitwise equal
(uint8), intrinsics and poses within POSE_TOL (the loaders' float32
arithmetic is the same; the bound only allows for it)."""

import json
import os

import numpy as np
import pytest

from torch_parity import TINY_FILES, dataset_args

from mlinerf_tpu.config import Config as JaxConfig
from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.utils import image_containers

POSE_TOL = 1e-6
PIKACHU = "configs/NRHints_Pikachu_a.yaml"
TRAIN_FORMATS = ["tiff_jpeg_ycbcr", "tiff_jpeg_rgb", "tiff_ycbcr_lzw", "tiff_zstd", "tiff_lzma_rgba16"]
SIZES = {"raw": (24, 24), "resized": (10, 10)}
# The second capture's train frames and their (extension, compression).
NEW_FORMATS = {"jp2": (".jp2", None), "j2k": (".j2k", None), "tiff_ojpeg": (".tif", 6)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """NRHints' layout at 24x24: 5 train frames, one in each of
    TRAIN_FORMATS, and 2 val frames in Zstandard TIFF."""
    root = str(tmp_path_factory.mktemp("tiff_codings_scene") / "nrh")
    annotations = fixtures.write_point_light(root, image_size=24, train=5, val=2, source="nrhints",
                                             image_format={"train": TRAIN_FORMATS, "val": "tiff_zstd"})
    return root, annotations


def test_stand_in_frames_use_the_codings(scene):
    """Each frame is a TIFF of its coding: compression and photometric."""
    root, annotations = scene
    want = {"tiff_jpeg_ycbcr": (7, 6), "tiff_jpeg_rgb": (7, 2), "tiff_ycbcr_lzw": (5, 6), "tiff_zstd": (50000, 2),
            "tiff_lzma_rgba16": (34925, 2)}
    for split, formats in (("train", TRAIN_FORMATS), ("val", ["tiff_zstd"] * 2)):
        frames = json.load(open(annotations[split]))["frames"]
        for fr, fmt in zip(frames, formats):
            path = os.path.join(root, fr["file_path"] + fr["file_ext"])
            lay = image_containers.tiff_layout(path, open(path, "rb").read())
            assert (lay.compression, lay.photometric) == want[fmt], fmt


@pytest.fixture(scope="module")
def jpeg2000_scene(tmp_path_factory):
    """NRHints' layout at 24x24: 3 train frames, one in each of
    NEW_FORMATS, and 2 val frames in JP2."""
    root = str(tmp_path_factory.mktemp("jpeg2000_scene") / "nrh")
    annotations = fixtures.write_point_light(root, image_size=24, train=3, val=2, source="nrhints",
                                             image_format={"train": list(NEW_FORMATS), "val": "jp2"})
    return root, annotations


def test_second_stand_in_frames_use_the_codings(jpeg2000_scene):
    """Each train frame is of its coding: the extension, and for the TIFF
    its compression."""
    root, annotations = jpeg2000_scene
    frames = json.load(open(annotations["train"]))["frames"]
    for fr, (ext, compression) in zip(frames, NEW_FORMATS.values()):
        path = os.path.join(root, fr["file_path"] + fr["file_ext"])
        assert fr["file_ext"] == ext
        if compression:
            assert image_containers.tiff_layout(path, open(path, "rb").read()).compression == compression


def _datasets(scene, size, is_inference):
    root, annotations = scene
    args = TINY_FILES + dataset_args(root, annotations, SIZES[size])
    jcfg, tcfg = JaxConfig(PIKACHU, cli_args=args), Config(PIKACHU, cli_args=args)
    return (jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=is_inference),
            resolve("dataset", tcfg.data.type)(tcfg, is_inference=is_inference))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
def test_tiff_coding_captures_match_jax(scene, size, split):
    jds, tds = _datasets(scene, size, is_inference=split == "val")
    want, got = jds.as_arrays(), tds.as_arrays()
    assert sorted(got) == sorted(want) and len(tds) == len(jds)
    assert got["images"].dtype == want["images"].dtype == np.uint8
    assert got["images"].shape[1:3] == SIZES[size]
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key == "images":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=POSE_TOL, err_msg=key)
    assert 0 < got["images"].mean() < 255


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
def test_jpeg2000_and_ojpeg_captures_match_jax(jpeg2000_scene, size, split):
    jds, tds = _datasets(jpeg2000_scene, size, is_inference=split == "val")
    want, got = jds.as_arrays(), tds.as_arrays()
    assert sorted(got) == sorted(want) and len(tds) == len(jds)
    assert got["images"].dtype == want["images"].dtype == np.uint8 and got["images"].shape[1:3] == SIZES[size]
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key == "images":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=POSE_TOL, err_msg=key)
