"""The port's occupancy grid (mlinerf_tpu_torch/ops/occupancy.py, the
occupancy branch of ``sample_dists_all`` and the trainer's grid upkeep)
against the JAX package's ops/occupancy.py on the same inputs, and the
claims tests/test_occupancy.py pins for JAX: the grid marks the surface's
shell, the lookup clamps, the coarse samples gather near the surface, an
empty grid falls back to the floor, a disabled grid leaves the uniform
samples as they are, and training refreshes the grid."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, model_pair, assert_model_pair_close

from mlinerf_tpu.ops import occupancy as jocc
from mlinerf_tpu_torch.ops import occupancy as occ


def sphere_sdf(points, radius=0.45):
    return np.linalg.norm(points, axis=-1) - radius


def _sphere_grid(R, band):
    coords = occ.grid_coordinates(R, -1.0, 1.0)
    return occ.occupancy_from_sdf(torch.from_numpy(sphere_sdf(coords)), R, -1.0, 1.0, band_cells=band)


def test_grid_matches_jax_and_marks_the_shell():
    R = 32
    coords = occ.grid_coordinates(R, -1.0, 1.0)
    np.testing.assert_array_equal(coords, jocc.grid_coordinates(R, -1.0, 1.0))
    sdf = sphere_sdf(coords).astype(np.float32)
    grid = occ.occupancy_from_sdf(torch.from_numpy(sdf), R, -1.0, 1.0, band_cells=2.0).numpy()
    np.testing.assert_array_equal(grid, np.asarray(jocc.occupancy_from_sdf(jnp.asarray(sdf), R, -1.0, 1.0, 2.0)))
    assert grid.shape == (R, R, R)
    cell, dist = 2.0 / R, np.abs(sdf).reshape(R, R, R)
    assert grid[dist < 1.9 * cell].all() and not grid[dist > 2.1 * cell].any()
    assert grid.mean() < 0.2


def test_lookup_nearest_cell_and_clamps():
    R = 16
    grid = torch.zeros(R, R, R)
    grid[8, 8, 8] = 1.0
    pts = torch.tensor([[0.05, 0.05, 0.05], [0.5, 0.5, 0.5], [5.0, 5.0, 5.0], [-3.0, 0.06, 0.07]])
    got = occ.lookup(grid, pts, -1.0, 1.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jocc.lookup(jnp.asarray(grid.numpy()), jnp.asarray(pts.numpy()),
                                                             -1.0, 1.0)))
    np.testing.assert_array_equal(got, [1.0, 0.0, 0.0, 0.0])


@pytest.mark.parametrize("stratified", [False, True], ids=["midpoints", "jittered"])
def test_coarse_dists_match_jax_and_concentrate(stratified):
    """Midpoint placement, and jittered on JAX's own uniforms: within 1e-5
    relative (the CDF is a float32 cumsum of 128 bins, summed in another
    order, and a narrow bin scales its rounding up); most samples land in
    the shells around the two crossings of the sphere (a uniform draw puts
    about 15% there)."""
    grid = _sphere_grid(64, 2.0)
    center = np.array([[[0.0, 0.0, -2.0], [0.1, -0.05, -2.0]]], np.float32)
    ray_unit = np.array([[[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]], np.float32)
    near, far = np.full((1, 2, 1), 1.0, np.float32), np.full((1, 2, 1), 3.0, np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jocc.occupancy_coarse_dists(jnp.asarray(grid.numpy()), jnp.asarray(center), jnp.asarray(ray_unit),
                                                  jnp.asarray(near), jnp.asarray(far), 64, -1.0, 1.0, march_bins=128,
                                                  floor=0.01, stratified=stratified, key=key))
    jitter = torch.from_numpy(np.asarray(jax.random.uniform(key, (1, 2, 64, 1)))) if stratified else None
    got = occ.occupancy_coarse_dists(grid, *(torch.from_numpy(a) for a in (center, ray_unit, near, far)), 64,
                                     -1.0, 1.0, march_bins=128, floor=0.01, stratified=stratified,
                                     jitter=jitter).numpy()
    assert got.shape == (1, 2, 64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    d = got[0, 0, :, 0]
    assert (np.diff(d) >= 0).all() and (d >= 1.0).all() and (d <= 3.0).all()
    assert ((np.abs(d - 1.55) < 0.15) | (np.abs(d - 2.45) < 0.15)).mean() > 0.5


def test_empty_grid_falls_back_to_the_floor():
    dists = occ.occupancy_coarse_dists(torch.zeros(16, 16, 16), torch.zeros(1, 2, 3),
                                       torch.tensor([[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]]),
                                       torch.full((1, 2, 1), 0.5), torch.full((1, 2, 1), 2.5), 32, -1.0, 1.0).numpy()
    assert np.isfinite(dists).all() and (dists >= 0.5 - 1e-5).all() and (dists <= 2.5 + 1e-5).all()
    assert dists[0, 0, :, 0].max() - dists[0, 0, :, 0].min() > 1.5


SETTINGS = ["--model.render.occupancy.resolution=16", "--model.render.occupancy.update_every=3",
            "--model.object.sdf.encoding.hashgrid.dtype=float32"]
OCC = ["--model.render.occupancy.enabled", *SETTINGS]


def _grid():
    """Occupied only for z in [0.5, 1) (hash-grid range [-2, 2], 16 cells)."""
    g = np.zeros((16, 16, 16), np.float32)
    g[:, :, 10:12] = 1.0
    return g


def test_sampling_branch_matches_jax():
    """A training forward and backward with the grid in both conds: the
    samples follow it (the model test's bounds on loss, outputs and
    gradients)."""
    jcfg, tcfg = configs(*OCC)
    pair = model_pair(jcfg, tcfg, jax_cond={"occupancy_grid": jnp.asarray(_grid())},
                      torch_cond={"occupancy_grid": torch.from_numpy(_grid())})
    assert_model_pair_close(pair)
    np.testing.assert_allclose(pair["tout"]["dists"], pair["jout"]["dists"], rtol=0, atol=1e-5)


def test_disabled_or_missing_grid_keeps_uniform_samples():
    from mlinerf_tpu_torch.models.lumen import Model
    from mlinerf_tpu_torch.models.neuralangelo import make_cond

    _, on = configs(*OCC)
    _, off = configs("--model.render.occupancy.enabled!", *SETTINGS)
    center = torch.zeros(1, 4, 3)
    ray_unit = torch.tensor([0.0, 0.0, 1.0]).expand(1, 4, 3)
    near, far = torch.full((1, 4, 1), 0.5), torch.full((1, 4, 1), 2.5)
    dists = {}
    for name, cfg in (("on", on), ("off", off)):
        model = Model(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0))
        cond = make_cond(cfg.model, 0, cfg.max_iter)
        dists[name] = model.sample_dists_all(center, ray_unit, near, far, cond, False, None)
        dists[name + "_grid"] = model.sample_dists_all(center, ray_unit, near, far,
                                                       dict(cond, occupancy_grid=torch.from_numpy(_grid())), False,
                                                       None)
    assert torch.equal(dists["on"], dists["off"]) and torch.equal(dists["off_grid"], dists["off"])
    assert not torch.allclose(dists["on_grid"], dists["on"])


def test_training_refreshes_the_grid(tmp_path):
    from mlinerf_tpu_torch.data.synthetic import Dataset
    from mlinerf_tpu_torch.trainers.lumen import Trainer

    _, cfg = configs(*OCC, "--max_iter=6", "--logging_iter=3")
    tr = Trainer(cfg, seed=0, logdir=str(tmp_path), device="cpu")
    refreshed = []
    update = tr.maybe_update_occupancy

    def recording():
        before = tr._occupancy_iter
        update()
        if tr._occupancy_iter != before:
            refreshed.append(tr.current_iteration)

    tr.maybe_update_occupancy = recording
    tr.train(Dataset(cfg).as_arrays())
    assert refreshed == [0, 3]
    grid = tr.occupancy_grid.numpy()
    assert grid.shape == (16, 16, 16) and 0.0 < grid.mean() < 1.0
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [3, 6] and all(np.isfinite(r["train/total_loss"]) for r in records)
