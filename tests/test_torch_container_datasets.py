"""The port's NRHints loader (``lumen_blender``) on a capture whose frames
are TIFF and BMP against the JAX package's (Pillow) loader, at TINY sizes:
the train frames in turn 16-bit RGBA LZW with predictor 2 (big-endian),
8-bit RGB Adobe Deflate, tiled PackBits, 24-bit BMP and 32-bit BMP with
alpha bitfields, the val frames 8-bit LZW TIFF, each split at the raw size
and resized. Images are bitwise equal (uint8), intrinsics and poses within
POSE_TOL (the loaders' float32 arithmetic is the same; the bound only
allows for it)."""

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
TRAIN_FORMATS = ["tiff_rgba16_lzw", "tiff_deflate", "tiff_tiled_packbits", "bmp", "bmp_bitfields"]
SIZES = {"raw": (24, 24), "resized": (10, 10)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """NRHints' layout at 24x24: 5 train frames, one in each of
    TRAIN_FORMATS, and 2 val frames in LZW TIFF."""
    root = str(tmp_path_factory.mktemp("container_scene") / "nrh")
    annotations = fixtures.write_point_light(root, image_size=24, train=5, val=2, source="nrhints",
                                             image_format={"train": TRAIN_FORMATS, "val": "tiff"})
    return root, annotations


def test_stand_in_frames_are_tiff_and_bmp(scene):
    root, annotations = scene
    for split, formats in (("train", TRAIN_FORMATS), ("val", ["tiff", "tiff"])):
        frames = json.load(open(annotations[split]))["frames"]
        assert [fr["file_ext"] for fr in frames] == [fixtures.FRAME_FORMATS[f][0] for f in formats]
        for fr in frames:
            head = open(os.path.join(root, fr["file_path"] + fr["file_ext"]), "rb").read(4)
            assert head in (b"II*\x00", b"MM\x00*") if fr["file_ext"] == ".tif" else head[:2] == b"BM"
    with pytest.raises(ValueError, match="source='nrhints'"):
        fixtures.write_point_light(os.path.join(root, "mli"), image_size=8, image_format="bmp")


def _datasets(scene, size, is_inference):
    root, annotations = scene
    args = TINY_FILES + dataset_args(root, annotations, SIZES[size])
    jcfg, tcfg = JaxConfig(PIKACHU, cli_args=args), Config(PIKACHU, cli_args=args)
    return (jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=is_inference),
            resolve("dataset", tcfg.data.type)(tcfg, is_inference=is_inference))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
def test_container_captures_match_jax(scene, size, split):
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


@pytest.mark.parametrize("fmt", sorted(fixtures.FRAME_FORMATS))
def test_frame_formats_keep_the_frame(fmt, tmp_path):
    """Each frame coding reads back (port and Pillow) to the 8-bit frame it
    was given: 16-bit TIFF samples are v * 257, whose high byte Pillow
    keeps; the alpha written beside RGB is opaque. A lossy WebP coding
    reads the same in both and stays within 6 levels of the frame on
    average."""
    from PIL import Image

    from mlinerf_tpu_torch.utils.image_io import read_image

    img = fixtures.camera_frame(3, (45, 29))
    ext, write = fixtures.FRAME_FORMATS[fmt]
    path = tmp_path / f"f{ext}"
    path.write_bytes(write(img))
    arr, mode = read_image(str(path))
    with Image.open(path) as im:
        assert im.mode == mode and np.array_equal(np.asarray(im), arr)
    assert arr.shape[-1] == 3 or (arr[..., 3] == 255).all()
    if fmt in fixtures.LOSSY_FORMATS:
        assert np.abs(arr[..., :3].astype(np.int64) - img).mean() < 6
    else:
        assert np.array_equal(arr[..., :3], img)
