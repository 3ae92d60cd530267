"""The port's pseudo-label pipeline (mlinerf_tpu_torch/ops/{morphology,kmeans,
knn}.py, pipelines/pseudo_label.py) against the JAX package's, on inputs
made with numpy from a seed: the morphology exactly, k-means with JAX's own
first-centre draws, the nearest-neighbour fill, the majority reflectance,
and the whole pipeline on a ``results_all`` fixture for ``unpair`` and
``pair``, whose npz the JAX package reads. The JAX package's own cases
(tests/test_pseudo_label.py) have their counterparts here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlinerf_tpu.ops import kmeans as jax_kmeans
from mlinerf_tpu.ops import knn as jax_knn
from mlinerf_tpu.ops import morphology as jax_morph
from mlinerf_tpu.pipelines import pseudo_label as jax_pl
from mlinerf_tpu.pipelines.label_store import load_results_all as jax_load_results_all
from mlinerf_tpu_torch.ops import kmeans, knn, morphology
from mlinerf_tpu_torch.pipelines import pseudo_label as pl


def jax_first_index(num_sets, num_points):
    """The first k-means centre of each set as the JAX package draws it
    (``kmeans_per_pixel`` splits PRNGKey(0) into one key per set)."""
    keys = jax.random.split(jax.random.PRNGKey(0), num_sets)
    draws = jax.vmap(lambda k: jax.random.randint(k, (), 0, num_points))(keys)
    return torch.from_numpy(np.asarray(draws).astype(np.int64))


def _square(h=16, w=16):
    x = np.zeros((h, w), np.float32)
    x[4:12, 4:12] = 1.0
    return x


def _blobs(seed, shape=(2, 24, 20)):
    """Binary images with blobs and isolated pixels."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=shape) > 0.98).astype(np.float32)
    x[..., 3:15, 5:14] = 1.0
    return x


# ---------------------------------------------------------------------------
# Morphology: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("op", ["erosion", "dilation", "edge"])
def test_morphology_exact(op, k):
    x = _blobs(k)
    got = getattr(morphology, op)(torch.from_numpy(x), k).numpy()
    want = np.asarray(getattr(jax_morph, op)(jnp.asarray(x), k))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("image,step", [("blobs", 1), ("blobs", 3), ("square", 2), ("empty", 2)])
def test_edge_weight_exact(image, step):
    """Equal to JAX's bit for bit, including the divide-by-max guard of an
    image with no edge; on the square (the JAX package's boundary case) the
    interior and the far outside are certain, the boundary is not."""
    x = {"blobs": _blobs(0)[0], "square": _square(), "empty": np.zeros((16, 16), np.float32)}[image]
    got = morphology.edge_weight(torch.from_numpy(x), step).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_morph.edge_weight(jnp.asarray(x), step)))
    if image == "square":
        assert got[8, 8] > 0.9 and got[4, 4] < 0.5 and got[0, 0] > 0.9
    if image == "empty":
        assert (got == 1).all()


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kmeans_per_pixel_matches_jax(k):
    """Labels equal and centres within 1e-6 (measured: 2.4e-7 at K = 1,
    the mean; 0 at K = 2 and 3) with JAX's first-centre draws passed in."""
    rng = np.random.default_rng(k)
    P, L = 300, 6
    vectors = rng.normal(0, 0.3, (P, L, 2)).astype(np.float32)
    vectors[:, L // 2:] += rng.normal(0, 1.0, (P, 1, 2)).astype(np.float32)
    want_labels, want_centers = jax_kmeans.kmeans_per_pixel(jnp.asarray(vectors), k)
    labels, centers = kmeans.kmeans_per_pixel(torch.from_numpy(vectors), k, first_index=jax_first_index(P, L))
    assert labels.dtype == torch.int32 and labels.shape == (P, L) and centers.shape == (P, k, 2)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(want_centers), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["two_blobs", "batched_per_pixel"])
def test_kmeans_separates_clusters(case):
    """The JAX package's two cases: two far blobs of 50 points, and 10
    pixels with 8 lights in two groups; each group gets one label."""
    rng = np.random.default_rng(0 if case == "two_blobs" else 1)
    if case == "two_blobs":
        pts = np.concatenate([rng.normal([0, 0], 0.1, (50, 2)), rng.normal([5, 5], 0.1, (50, 2))])[None]
        labels, centers = kmeans.kmeans(torch.tensor(pts, dtype=torch.float32), 2, num_iters=10)
        c = np.sort(centers[0].numpy(), axis=0)
        np.testing.assert_allclose(c, [[0, 0], [5, 5]], atol=0.15)
    else:
        pts = rng.normal(0, 0.05, (10, 8, 2))
        pts[:, 4:] += 3.0
        labels, _ = kmeans.kmeans_per_pixel(torch.tensor(pts, dtype=torch.float32), 2)
    half = labels.shape[1] // 2
    for row in labels.numpy():
        assert len(set(row[:half])) == 1 and len(set(row[half:])) == 1 and row[0] != row[-1]


def test_first_indices_same_on_every_device():
    """The default draws come from a CPU generator: the same on any device."""
    a = kmeans.first_indices(1000, 4)
    assert torch.equal(a, kmeans.first_indices(1000, 4, device="cpu"))
    assert int(a.min()) == 0 and int(a.max()) == 3


# ---------------------------------------------------------------------------
# Nearest-neighbour fill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["simple", "random"])
def test_masked_nearest_fill_matches_jax(case):
    """The JAX package's three-pixel case exactly; on 3,000 random pixels
    (two chunks) the picks by count: at most 1% of the filled pixels take
    another value (measured: 0), the valid ones keep theirs."""
    if case == "simple":
        values = np.asarray([[1.0], [2.0], [999.0]], np.float32)
        feats = np.asarray([[0.0], [10.0], [0.1]], np.float32)
        valid = np.asarray([True, True, False])
    else:
        rng = np.random.default_rng(5)
        values = rng.uniform(size=(3000, 3)).astype(np.float32)
        feats = rng.normal(size=(3000, 9)).astype(np.float32)
        valid = rng.uniform(size=3000) > 0.3
    got = knn.masked_nearest_fill(torch.from_numpy(values), torch.from_numpy(feats), torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_knn.masked_nearest_fill(jnp.asarray(values), jnp.asarray(feats), jnp.asarray(valid)))
    if case == "simple":
        np.testing.assert_allclose(got, [[1.0], [2.0], [1.0]])
    np.testing.assert_array_equal(got[valid], values[valid])
    differ = np.any(got != want, axis=-1)
    assert differ.sum() <= 0.01 * (~valid).sum(), int(differ.sum())


def test_nearest_neighbor_matches_jax():
    rng = np.random.default_rng(6)
    q, db = rng.normal(size=(500, 4)).astype(np.float32), rng.normal(size=(700, 4)).astype(np.float32)
    idx, dist = knn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(db), chunk=128)
    want_idx, want_dist = jax_knn.nearest_neighbor(jnp.asarray(q), jnp.asarray(db), 128)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist), atol=1e-5)
    simple, _ = knn.nearest_neighbor(torch.tensor([[1.0, 0], [9, 1], [1, 9]]),
                                     torch.tensor([[0.0, 0], [10, 0], [0, 10]]))
    np.testing.assert_array_equal(simple.numpy(), [0, 1, 2])


# ---------------------------------------------------------------------------
# Reflectance pieces
# ---------------------------------------------------------------------------


def test_rgb2opp_matches_jax():
    imgs = np.random.default_rng(7).uniform(size=(4, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(pl.rgb2opp(torch.from_numpy(imgs)).numpy(), np.asarray(jax_pl.rgb2opp(jnp.asarray(imgs))),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", ["majority", "random"])
def test_find_best_ref_matches_jax(case):
    """The JAX package's majority case (light 2 disagrees: the mean of
    lights 0 and 1 is 2); random labels, masks and shadings within 1e-6."""
    if case == "majority":
        L, H, W, K = 3, 2, 2, 2
        mask = np.ones((L, H, W), bool)
        labels = np.stack([np.zeros((H, W)), np.zeros((H, W)), np.ones((H, W))]).astype(np.int32)
        shadings = np.ones((L, H, W), np.float32)
        ref = np.stack([np.full((H, W, 3), v, np.float32) for v in (1.0, 3.0, 100.0)])
        thr = 0.5
    else:
        rng = np.random.default_rng(8)
        L, H, W, K = 5, 12, 10, 3
        shadings = rng.uniform(size=(L, H, W)).astype(np.float32) * (rng.uniform(size=(L, H, W)) > 0.2)
        mask = shadings > 0
        labels = rng.integers(0, K, (L, H, W)).astype(np.int32)
        ref = rng.uniform(size=(L, H, W, 3)).astype(np.float32)
        thr = 0.6
    got = pl.find_best_ref(torch.from_numpy(mask), torch.from_numpy(labels), K, torch.from_numpy(shadings), thr,
                           torch.from_numpy(ref)).numpy()
    want = np.asarray(jax_pl.find_best_ref(jnp.asarray(mask), jnp.asarray(labels), K, jnp.asarray(shadings), thr,
                                           jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if case == "majority":
        np.testing.assert_allclose(got, 2.0, atol=1e-5)


# ---------------------------------------------------------------------------
# The whole pipeline
# ---------------------------------------------------------------------------


def results_all_fixture(seed=0, cams=2, lights=4, H=24, W=24, pair=False):
    """A ``results_all`` store like ``test_all_light``'s: a disk of surface
    in front of a white background, two albedo regions, lit from 4 sides
    with a cast shadow each."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    out = {}
    for c in range(cams):
        r2 = (xs - 0.1 * c) ** 2 + ys ** 2
        inside = r2 < 0.7
        nz = np.sqrt(np.clip(1 - r2, 0, 1))
        normal = np.stack([xs, ys, nz], -1) * inside[..., None]
        albedo = np.where((xs > 0.2 * c)[..., None], [0.8, 0.3, 0.2], [0.2, 0.5, 0.7]) * (1 + 0.05 * rng.normal(size=(H, W, 1)))
        cam = {}
        for li in range(lights):
            angle = 2 * np.pi * li / lights + 0.3 * c
            ldir = np.asarray([np.cos(angle), np.sin(angle), 1.0]) / np.sqrt(2)
            nxl = np.clip(normal @ ldir, 0, 1) * inside
            shadow = (np.cos(angle) * xs + np.sin(angle) * ys) < -0.5
            vis = (inside & ~shadow).astype(np.float32)
            img = np.where(inside[..., None], albedo * (nxl * vis)[..., None] ** (1 / 2.2), 1.0)
            maps = {"normal": normal, "normal_x_light": nxl[..., None], "rgb_render": img,
                    "visibility": vis[..., None], "inter_mask": inside[..., None].astype(np.float32)}
            if pair:
                maps["rgb_target"] = np.clip(img + 0.01 * rng.normal(size=img.shape), 0, 1)
            cam[str(li)] = {k: v[None].astype(np.float32) for k, v in maps.items()}
        out[str(c)] = cam
    return out


@pytest.mark.parametrize("setting", ["unpair", "pair"])
def test_generate_pseudo_labels_matches_jax(setting, tmp_path):
    """Shading and certainty within 1e-5 (measured: 6e-8 and 0). The
    reflectance by count: at most 1% of the pixels differ by more than 1e-4
    (measured: 0 of 576 per camera), and within 1e-4 on the others
    (measured: 6e-8). The port's npz reads back through the JAX package's
    loader."""
    results = results_all_fixture(pair=setting == "pair")
    H, W = results["0"]["0"]["visibility"].shape[1:3]
    want = jax_pl.generate_pseudo_labels(results, setting)
    got = pl.generate_pseudo_labels(results, setting, output_path=str(tmp_path), device="cpu", save_pngs=True,
                                    first_index=jax_first_index(H * W, 4))
    assert sorted(got) == sorted(want)
    for cam in want:
        assert sorted(got[cam]) == sorted(want[cam])
        for light in want[cam]:
            if light == "pseudo_reflectance":
                continue
            for key in ("pseudo_shading_gamma", "visibility_certainty"):
                assert got[cam][light][key].shape == (H, W, 1)
                np.testing.assert_allclose(got[cam][light][key], want[cam][light][key], rtol=0, atol=1e-5)
        ref, ref_want = got[cam]["pseudo_reflectance"], want[cam]["pseudo_reflectance"]
        assert ref.shape == (H, W, 3) and np.isfinite(ref).all() and ref.std() > 0
        differ = np.any(np.abs(ref - ref_want) > 1e-4, axis=-1)
        assert differ.sum() <= 0.01 * H * W, int(differ.sum())
    loaded = jax_load_results_all(str(tmp_path / "pseudo_label_all"))
    for cam in got:
        np.testing.assert_array_equal(loaded[cam]["pseudo_reflectance"], got[cam]["pseudo_reflectance"])
        for light in results[cam]:
            np.testing.assert_array_equal(loaded[cam][light]["pseudo_shading_gamma"],
                                          got[cam][light]["pseudo_shading_gamma"])
    assert (tmp_path / "0_pseudo_reflectance.png").exists() and (tmp_path / "1_3_visibility_certainty.png").exists()


def test_single_light_runs():
    """One cluster: every label 0, the centres are the means; finite labels."""
    results = results_all_fixture(cams=1, lights=1)
    got = pl.generate_pseudo_labels(results, "single_light", device="cpu")
    assert np.isfinite(got["0"]["pseudo_reflectance"]).all()
