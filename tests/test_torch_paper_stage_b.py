"""The inputs of the paper's stage b on its MLI-synthetic and NRHints
layouts (tests/torch_paper.py) in the port against the JAX package at the
TINY size, from one JAX stage-a checkpoint:

- ``test_all_light`` with ``dataset_type="unpair"`` (``unpairlights_train``):
  the lights each package asks of its dataset (the (camera, light) -> frame
  map of Python ``random`` with seed 999), and the maps;
- the port's ``unpair`` pseudo labels from JAX's renders, with JAX's first
  k-means centres, against JAX's labels;
- both packages' stage-b datasets reading JAX's labels (the uint8 images
  and the labels at the train size).

One stage-b step on these labels: tests/test_torch_paper_stage_b_step.py.
"""

import os

import numpy as np
import pytest

from torch_paper import LAYOUTS, SIZE, datasets, jax_first_index, jax_stage_a, jax_unpair, port_inference_trainer, \
    write_scenes

from mlinerf_tpu.trainers.lumen import get_random_other_index as jax_random_other_index
from mlinerf_tpu_torch.pipelines import pseudo_label
from mlinerf_tpu_torch.pipelines.label_store import load_results_all
from mlinerf_tpu_torch.trainers.lumen import get_random_other_index

RENDER_TOL = 1e-4  # tests/test_torch_rene_pipeline.py's limitedlights bound
LABEL_TOL = 1e-6


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("paper"))


def _recording_get_light(dataset, calls):
    original = dataset.get_light
    dataset.get_light = lambda idx: calls.append(int(idx)) or original(idx)


@pytest.fixture(scope="module")
def renders(scenes, tmp_path_factory):
    """``unpairlights_train``'s renders of each layout by both packages from
    one JAX checkpoint, the lights each asked of its dataset, and JAX's
    labels of JAX's renders."""
    jtr, pointer = jax_stage_a(scenes, str(tmp_path_factory.mktemp("jax_a")))
    out = dict(pointer=pointer)
    for layout in LAYOUTS:
        ttr = port_inference_trainer(scenes, layout, pointer, str(tmp_path_factory.mktemp("port_a")))
        jds, tds = datasets(scenes, layout, "a")
        jcalls, tcalls = [], []
        _recording_get_light(jds, jcalls)
        _recording_get_light(tds, tcalls)
        root = tmp_path_factory.mktemp(f"renders_{layout}")
        want, labels, label_file = jax_unpair(jtr, jds, str(root / "jax"))
        got = ttr.test_all_light(tds, str(root / "port"), dataset_type="unpair", sample_num=4, seed=999)
        out[layout] = dict(want=want, got=got, jcalls=jcalls, tcalls=tcalls, root=root, labels=labels,
                           label_file=label_file, frames=len(tds))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unpair_render_map_matches_jax(renders, layout):
    """Each frame under its own light and those of 3 other frames drawn by
    Python ``random`` with seed 999: the same draws, the same lights asked
    of the dataset in the same order, the same (camera, light) keys; the
    captured image saved as ``0_rgb_target.png`` only, and no rgb_target in
    the results."""
    r = renders[layout]
    picks = get_random_other_index(r["frames"], 4, 999)
    assert picks == jax_random_other_index(r["frames"], 4, 999)
    assert all(len(set(p)) == 4 and p[0] == i for i, p in enumerate(picks))
    assert r["tcalls"] == r["jcalls"] and len(r["tcalls"]) == 4 * r["frames"]
    # get_full_sample asks for the frame's own light; the others follow.
    assert [c for i, c in enumerate(r["tcalls"]) if i % 4] == [f for p in picks for f in p[1:]]
    assert {c: sorted(v) for c, v in r["got"].items()} == {c: sorted(v) for c, v in r["want"].items()} == {
        str(c): ["0", "1", "2", "3"] for c in range(r["frames"])}
    for cam in r["got"]:
        assert all(sorted(m) == ["inter_mask", "normal", "normal_x_light", "rgb_render", "visibility"]
                   for m in r["got"][cam].values())
        files = os.listdir(r["root"] / "port" / cam)
        assert "0_rgb_target.png" in files and not any(f"{k}_rgb_target.png" in files for k in (1, 2, 3))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unpair_render_maps_match_jax(renders, layout):
    """rgb, normal and normal.light within 1e-4 where the boolean maps
    agree; visibility and inter_mask differ on at most 1% of a render's
    pixels, plus one."""
    r = renders[layout]
    hits = 0
    for cam in r["want"]:
        for light in r["want"][cam]:
            w, g = r["want"][cam][light], r["got"][cam][light]
            agree = np.ones(w["visibility"].shape, bool)
            for key in ("visibility", "inter_mask"):
                assert g[key].shape == w[key].shape == (1, *SIZE, 1)
                differ = g[key] != w[key]
                assert differ.sum() <= 0.01 * differ.size + 1, (cam, light, key)
                agree &= ~differ
            for key in ("rgb_render", "normal", "normal_x_light"):
                mask = np.broadcast_to(agree[..., :1], g[key].shape)
                np.testing.assert_allclose(g[key][mask], w[key][mask], rtol=0, atol=RENDER_TOL,
                                           err_msg=f"{cam}/{light}/{key}")
            hits += int(w["inter_mask"].sum())
    assert hits > 0  # the renders see the surface


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unpair_labels_from_jax_renders_match_jax(renders, layout):
    """The port's ``unpair`` labels (k = 2, 10 fill search points) from
    JAX's ``results_all``, read back by the port's store, with JAX's first
    k-means centres: every map within 1e-6 of JAX's labels."""
    r = renders[layout]
    results = load_results_all(str(r["root"] / "jax" / "results_all"))
    got = pseudo_label.generate_pseudo_labels(results, "unpair", device="cpu",
                                              first_index=jax_first_index(SIZE[0] * SIZE[1], 4))
    want = r["labels"]
    assert sorted(got) == sorted(want) == [str(c) for c in range(r["frames"])]
    for cam in want:
        assert sorted(got[cam]) == sorted(want[cam]) == ["0", "1", "2", "3", "pseudo_reflectance"]
        np.testing.assert_allclose(got[cam]["pseudo_reflectance"], np.asarray(want[cam]["pseudo_reflectance"]),
                                   rtol=0, atol=LABEL_TOL, err_msg=cam)
        for light in (k for k in want[cam] if k != "pseudo_reflectance"):
            for key, value in want[cam][light].items():
                np.testing.assert_allclose(got[cam][light][key], np.asarray(value), rtol=0, atol=LABEL_TOL,
                                           err_msg=f"{cam}/{light}/{key}")
    assert pseudo_label.PARAMS["unpair"]["kmeans_num_clusters"] == 2
    assert pseudo_label.PARAMS["unpair"]["fill_search_points"] == 10


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_b_arrays_match_jax(scenes, renders, layout):
    """Both packages' stage-b datasets on JAX's labels: the uint8 images and
    the float32 labels at the train size beside them, equal; frame i's
    labels are camera str(i)'s, light "0". MLI composites on white and
    NRHints does not."""
    r = renders[layout]
    jds, tds = datasets(scenes, layout, "b", f"--data.train.pseudo_label.pt_file={r['label_file']}")
    want, got = jds.as_arrays(), tds.as_arrays()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    n = r["frames"]
    assert got["images"].dtype == np.uint8 and got["images"].shape == (n, *SIZE, 3)
    for key, channels in (("pseudo_ref", 3), ("pseudo_sha", 1), ("pseudo_visibility_certainty", 1)):
        assert got[key].dtype == np.float32 and got[key].shape == (n, *SIZE, channels), key
    labels = r["labels"]
    np.testing.assert_array_equal(got["pseudo_ref"][2], np.asarray(labels["2"]["pseudo_reflectance"], np.float32))
    np.testing.assert_array_equal(got["pseudo_sha"][1], np.asarray(labels["1"]["0"]["pseudo_shading_gamma"],
                                                                   np.float32))
    assert tds.white_background == (layout == "mli") and not tds.load_iid
    corner = got["images"][:, 0, 0]
    assert (corner == 255).all() if layout == "mli" else (corner < 16).all()
