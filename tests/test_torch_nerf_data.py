"""The port's ``nerf_blender`` and ``nerf_llff`` datasets against the JAX
package's loaders on stand-ins in their layouts (data/fixtures.py): every
array of both splits bitwise equal (uint8 images resized to Pillow's
definition, intrinsics, poses), on PNG and on JPEG frames (fern's own
format); frames that are not whole JPEGs raise naming the file."""

import os

import numpy as np
import pytest

from mlinerf_tpu.config import Config as JaxConfig
from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures

BLENDER = "configs/nerf_blender.yaml"
LLFF = "configs/nerf_llff.yaml"


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A NeRF-synthetic stand-in (RGBA 96x96 raw, 3 train and 2 val frames)
    and an LLFF one (96x72 raw, 9 frames: 7 train, 2 val)."""
    root = tmp_path_factory.mktemp("nerf_scenes")
    fixtures.write_nerf_synthetic(str(root / "lego"), image_size=96, train=3, val=2, render_div=2)
    fixtures.write_llff(str(root / "fern"), raw_size=(96, 72), render_div=2)
    return {BLENDER: (str(root / "lego"), [48, 48]), LLFF: (str(root / "fern"), [36, 48])}


def _configs(scenes, config, *extra):
    root, size = scenes[config]
    args = [f"--data.root={root}", f"--data.train.image_size={size}", f"--data.val.image_size={size}", *extra]
    return JaxConfig(config, cli_args=args), Config(config, cli_args=args)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("config", [BLENDER, LLFF], ids=["nerf_blender", "nerf_llff"])
def test_arrays_bitwise_equal_to_jax(scenes, config, split):
    jcfg, tcfg = _configs(scenes, config)
    inference = split == "val"
    want = jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=inference).as_arrays()
    got = resolve("dataset", tcfg.data.type)(tcfg, is_inference=inference).as_arrays()
    assert sorted(got) == sorted(want) == ["images", "intr", "pose"]
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # The val subsets (nerf_blender: 4 of 2 frames, repeated; nerf_llff: 2 of the views 0 and 8).
    assert len(got["images"]) == {("train", BLENDER): 3, ("val", BLENDER): 4,
                                  ("train", LLFF): 7, ("val", LLFF): 2}[(split, config)]
    assert got["images"].dtype == np.uint8 and 0 < got["images"].mean() < 255


def test_blender_rgba_composites_on_bgcolor(scenes):
    """Transparent pixels take ``data.bgcolor`` (0.0 here) in both packages."""
    jcfg, tcfg = _configs(scenes, BLENDER, "--data.bgcolor=0.0")
    got = resolve("dataset", tcfg.data.type)(tcfg).as_arrays()["images"]
    want = jax_resolve("dataset", jcfg.data.type)(jcfg).as_arrays()["images"]
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all(-1).mean() > 0.5


def test_llff_refuses_jpeg_frames(scenes, tmp_path):
    """A capture whose frames are JPEG (as fern's are) reads as the JAX
    loader reads it: every array of both splits equal (images bitwise).
    Frames that are not whole JPEGs (an SOI and nothing after it) raise,
    naming the file and the reason."""
    root, size = scenes[LLFF]
    jpeg_root = tmp_path / "fern_jpeg"
    fixtures.write_llff(str(jpeg_root), raw_size=(96, 72), render_div=2, image_format="jpeg")
    args = [f"--data.root={jpeg_root}", f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    jcfg, tcfg = JaxConfig(LLFF, cli_args=args), Config(LLFF, cli_args=args)
    for inference in (False, True):
        want = jax_resolve("dataset", "nerf_llff")(jcfg, is_inference=inference).as_arrays()
        got = resolve("dataset", "nerf_llff")(tcfg, is_inference=inference).as_arrays()
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    broken = tmp_path / "fern_broken"
    (broken / "images").mkdir(parents=True)
    os.symlink(os.path.join(root, "poses_bounds.npy"), broken / "poses_bounds.npy")
    for i in range(9):
        (broken / "images" / f"IMG_{4026 + i}.JPG").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    cfg = Config(LLFF, cli_args=[f"--data.root={broken}"])
    dataset = resolve("dataset", "nerf_llff")(cfg)
    with pytest.raises(ValueError, match=r"IMG_4027.JPG: JPEG: truncated"):
        dataset.get_full_sample(0)
