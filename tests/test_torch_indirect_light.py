"""The indirect-light probe and its hemisphere geometry in the port
(mlinerf_tpu_torch/utils/hemisphere.py, pipelines/indirect_light.py)
against the JAX package's: the spiral, the square unwrap (bitwise, and in
column chunks against one dense pass), the rotation of +z onto normals,
and the probe of tests/test_indirect_light.py (probe resolution 16, grid
fraction 0.5) on a 12 x 20 view through both packages from one JAX
checkpoint of perturbed params.

Tolerances: the spiral and the unwrap bitwise (the same float64 numpy,
and the distances' subtract, square and add each rounded once on either
side); the rotations within 1e-6 (float32, sums in another order); the
frustum masks equal but for at most 1% of the rays (a hit point on the
frustum's edge), the mosaic within 1e-4 but for at most 1% of its pixels
(measured: every pixel within 2.1e-7, the masks equal)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, jax_stage_a_checkpoint

from mlinerf_tpu.data.synthetic import Dataset as JaxDataset
from mlinerf_tpu.pipelines.indirect_light import indirect_light_probe as jax_probe
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu.utils import camera as jax_camera
from mlinerf_tpu.utils import hemisphere as jax_hemisphere
from mlinerf_tpu_torch.ops import hashgrid_scatter
from mlinerf_tpu_torch.pipelines.indirect_light import indirect_light_probe
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer
from mlinerf_tpu_torch.utils import camera, hemisphere

# A view wider than it is high: the frustum test holds the column against
# the height (camera.inside_camera_view), so the probed column 12 >= H is
# out of view in both packages.
H, W = 12, 20
SMALL = [f"--data.train.image_size=[{H},{W}]", f"--data.val.image_size=[{H},{W}]", "--model.render.rand_rays_val=256"]


@pytest.mark.parametrize("N", [256, 1024, 90_000])
def test_hemisphere_spiral_matches_jax(N):
    got = hemisphere.hemisphere_spiral(N)
    np.testing.assert_array_equal(got, jax_hemisphere.hemisphere_spiral(N))
    assert got.shape == (N, 3) and got.dtype == np.float32 and (got[:, 2] >= 0).all()


@pytest.mark.parametrize("N", [256, 1024])
def test_square_interpolation_matches_jax_bitwise(N):
    want_index, want_mask, want_shape = jax_hemisphere.square_interpolation(N)
    index, mask, shape = hemisphere.square_interpolation(N)
    assert shape == want_shape
    np.testing.assert_array_equal(index, want_index)
    np.testing.assert_array_equal(mask, want_mask)
    assert index.dtype == np.int64 and mask.dtype == bool


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_square_interpolation_chunks_match_one_pass(chunk, monkeypatch):
    """Column chunks of 1, 7 (not dividing S*S) and 100 pixels give the one
    dense pass's index: each column's first minimum is its own."""
    N = 1024
    monkeypatch.setitem(hemisphere.CHUNK_ELEMENTS, "cpu", N * N)
    dense_index, dense_mask, _ = hemisphere.square_interpolation(N)
    monkeypatch.setitem(hemisphere.CHUNK_ELEMENTS, "cpu", N * chunk)
    index, mask, _ = hemisphere.square_interpolation(N)
    np.testing.assert_array_equal(index, dense_index)
    np.testing.assert_array_equal(mask, dense_mask)


def test_square_interpolation_small_sizes_one_pixel_per_chunk(monkeypatch):
    """N = 4, 9 and 16 (S = 2, 3, 4), one pixel per chunk, bitwise."""
    for N in (4, 9, 16):
        monkeypatch.setitem(hemisphere.CHUNK_ELEMENTS, "cpu", N)
        want_index, _, _ = jax_hemisphere.square_interpolation(N)
        np.testing.assert_array_equal(hemisphere.square_interpolation(N)[0], want_index)


def test_rotation_from_z_matches_jax():
    """Random normals (not unit length), +z (the identity) and -z (a half
    turn about x); each rotation takes +z onto its normal."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, 7, 3)).astype(np.float32) * 2.0
    v[0, 0] = [0.0, 0.0, 3.0]
    v[0, 1] = [0.0, 0.0, -0.5]
    got = hemisphere.rotation_from_z(torch.from_numpy(v)).numpy()
    want = np.asarray(jax_hemisphere.rotation_from_z(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, 0], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got[0, 1], np.diag([1.0, -1.0, -1.0]).astype(np.float32))
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(got[..., :, 2], unit, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    """The probe (probe resolution 16, grid fraction 0.5: pixels (4, 4) and
    (4, 12), 256 rays each) of the first validation view at H x W through
    both packages, from one JAX checkpoint at iteration 700 of perturbed
    params, without the white background. Each package's frustum mask is
    recorded."""
    jcfg, tcfg = configs(*SMALL, "--model.background.white=False")
    logdir = str(tmp_path_factory.mktemp("probe"))
    pointer = jax_stage_a_checkpoint(jcfg, logdir, iteration=700)
    jtr = JaxTrainer(jcfg, is_inference=True, seed=0, logdir=logdir)
    assert jtr.load_checkpoint(pointer, resume=False, load_opt=False)
    sample = JaxDataset(jcfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if k in ("pose", "intr", "pose_light")}
    ttr = TorchTrainer(tcfg, is_inference=True, seed=0, logdir=str(tmp_path_factory.mktemp("port")), device="cpu")
    assert ttr.load_checkpoint(pointer)
    masks = {}

    def recording(module, name):
        original = module.inside_camera_view

        def inside(*args, **kwargs):
            masks[name] = np.asarray(original(*args, **kwargs))
            return masks[name] if name == "jax" else torch.from_numpy(masks[name])

        return inside

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_camera, "inside_camera_view", recording(jax_camera, "jax"))
        mp.setattr(camera, "inside_camera_view", recording(camera, "port"))
        want = jax_probe(jtr, data, (H, W), probe_resolution=16, grid_fraction=0.5, num_rays_chunk=1024)
        before = hashgrid_scatter.launches
        got = indirect_light_probe(ttr, data, (H, W), probe_resolution=16, grid_fraction=0.5)
        launches = hashgrid_scatter.launches - before
    return dict(got=got, want=want, launches=launches, masks=masks)


def test_probe_grid_and_shape_match_jax(probes):
    """The probed pixels, the mosaic's shape and the view's render (within
    1e-4, as tests/test_torch_inference.py holds full renders); no scatter
    launched."""
    got, want = probes["got"], probes["want"]
    assert got["grid_rows"] == want["grid_rows"] == [4] and got["grid_cols"] == want["grid_cols"] == [4, 12]
    assert got["indirect_rgb"].shape == want["indirect_rgb"].shape == (16, 32, 3)
    assert got["indirect_rgb"].dtype == np.float32 and np.isfinite(got["indirect_rgb"]).all()
    np.testing.assert_allclose(got["rgb_map"], np.asarray(want["rgb_map"]), rtol=0, atol=1e-4)
    assert probes["launches"] == 0


def test_probe_frustum_masks_match_jax(probes):
    """The same rays leave the frustum in both packages (at most 1% decided
    apart): every ray of the probe at column 12 (the reference's fault the
    port mirrors), none of the probe at column 4 (its hits stay near it)."""
    got, want = probes["masks"]["port"], probes["masks"]["jax"]
    assert got.shape == want.shape == (1, 2 * 256)
    assert (got != want).mean() <= 0.01
    assert want[0, :256].all() and not want[0, 256:].any()


def test_probe_mosaic_matches_jax(probes):
    got, want = probes["got"]["indirect_rgb"], np.asarray(probes["want"]["indirect_rgb"])
    off = np.abs(got - want).max(-1) > 1e-4
    assert off.mean() <= 0.01, f"{off.sum()} of {off.size} mosaic pixels differ"
    # Out-of-disc pixels are 1.0 and the masked tile's disc 0.0 on both sides.
    assert (got == 1.0).all(-1).sum() == (want == 1.0).all(-1).sum() > 0
    disc = (want[:, 16:] != 1.0).any(-1)
    assert disc.any() and (got[:, 16:][disc] == 0.0).all()
