"""The port's file-backed datasets (mlinerf_tpu_torch/data/{lumen,
lumen_blender,blender}.py) against the JAX package's classes, on fixtures
in the ReNe, MLI-synthetic and NRHints layouts written with Pillow: the
stacked arrays (uint8 images bitwise equal, at the raw size and resized;
poses and intrinsics within 1e-6), the frame filters and lookups, the
ground-truth intrinsics composited on white, the pseudo-label arrays in both
layouts, the uint8 pixel gather against JAX's ``sample_batch``, the registry,
and one TINY training step of each paper config on the CPU."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY_FILES, dataset_args, pil_save

from mlinerf_tpu.config import Config as JaxConfig
from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu.data.blender import gl_to_cv as jax_gl_to_cv
from mlinerf_tpu.data.blender import invert_pose as jax_invert_pose
from mlinerf_tpu.trainers.base import BaseTrainer as JaxBaseTrainer
from mlinerf_tpu.trainers.lumen import Trainer as JaxLumenTrainer
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.data.blender import gl_to_cv, invert_pose
from mlinerf_tpu_torch.pipelines.label_store import save_results_all
from mlinerf_tpu_torch.trainers.base import BaseTrainer
from mlinerf_tpu_torch.trainers.lumen import Trainer as LumenTrainer

POSE_TOL = 1e-6
RENE = "configs/rene_savannah_a.yaml"
HOTDOG = "configs/syn_hotdog_a.yaml"
PIKACHU = "configs/NRHints_Pikachu_a.yaml"
# The ReNe fixture's raw frames are 144x108: a tenth of the camera's.
RENE_RAW = (144, 108)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    rene = fixtures.write_rene(str(root / "rene"), "dataset_rene/savannah", cameras=2, lights=3, raw_size=RENE_RAW,
                               save=pil_save)
    mli = fixtures.write_point_light(str(root / "mli"), image_size=24, train=4, val=3, lights=3, save=pil_save)
    nrh = fixtures.write_point_light(str(root / "nrh"), image_size=24, train=4, val=2, source="nrhints",
                                     save=pil_save)
    return {RENE: (str(root / "rene"), rene), HOTDOG: (str(root / "mli"), mli), PIKACHU: (str(root / "nrh"), nrh)}


def _configs(scenes, config, size, *extra, stage="a"):
    """Both packages' configs of ``config``'s fixture; ``stage="b"`` loads
    the scene's stage-b config (the one with pseudo labels)."""
    root, annotations = scenes[config]
    args = TINY_FILES + dataset_args(root, annotations, size) + list(extra)
    path = config.replace("_a.yaml", f"_{stage}.yaml")
    return JaxConfig(path, cli_args=args), Config(path, cli_args=args)


def _datasets(scenes, config, size, *extra, is_inference=False, stage="a"):
    jcfg, tcfg = _configs(scenes, config, size, *extra, stage=stage)
    return (jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=is_inference),
            resolve("dataset", tcfg.data.type)(tcfg, is_inference=is_inference))


def _assert_arrays_equal(want, got):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key in ("pose", "intr", "pose_light"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=POSE_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


SIZES = {RENE: {"raw": (108, 144), "resized": (27, 36)}, HOTDOG: {"raw": (24, 24), "resized": (16, 16)},
         PIKACHU: {"raw": (24, 24), "resized": (10, 10)}}


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", ["raw", "resized"])
@pytest.mark.parametrize("config", [RENE, HOTDOG, PIKACHU], ids=["rene", "mli", "nrhints"])
def test_as_arrays_match_jax(scenes, config, size, split):
    """uint8 images bitwise equal at the raw size and after the resize (the
    resize's tolerance is 1/255; it is bit-equal to Pillow here)."""
    jds, tds = _datasets(scenes, config, SIZES[config][size], is_inference=split == "val")
    assert type(tds).images_uint8 and len(tds) == len(jds)
    want, got = jds.as_arrays(), tds.as_arrays()
    assert got["images"].dtype == np.uint8
    _assert_arrays_equal(want, got)


def test_rene_camera_model(scenes):
    """Skewed intrinsics scaled from the raw size, box-bounded scene poses,
    light poses from transform_matrix_light."""
    _, tds = _datasets(scenes, RENE, (27, 36))
    meta = tds.meta
    intr, pose = tds.get_camera(0)
    assert meta["sk_x"] != 0 and intr[0, 1] == pytest.approx(np.float32(meta["sk_x"]) * np.float32(36 / 144))
    assert intr[0, 0] == pytest.approx(np.float32(meta["fl_x"]) * np.float32(36 / 144))
    assert intr[1, 1] == pytest.approx(np.float32(meta["fl_y"]) * np.float32(27 / 108))
    c2w = np.asarray(tds.list[0]["transform_matrix_light"], np.float32)
    np.testing.assert_allclose(tds.get_light(0), invert_pose(gl_to_cv(c2w)[:3]), atol=POSE_TOL)


def test_readjust_moves_and_scales_the_scene(scenes):
    extra = ["--data.readjust.center=[0.1,-0.2,0.05]", "--data.readjust.scale=1.5"]
    jds, tds = _datasets(scenes, RENE, (27, 36), *extra)
    for i in range(len(tds)):
        np.testing.assert_allclose(tds.get_camera(i)[1], jds.get_camera(i)[1], atol=POSE_TOL)
        np.testing.assert_allclose(tds.get_light(i), jds.get_light(i), atol=POSE_TOL)


def test_gl_to_cv_and_invert_pose_match_jax():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3], c2w[:3, 3] = q, rng.normal(size=3)
    np.testing.assert_array_equal(gl_to_cv(c2w), jax_gl_to_cv(c2w))
    np.testing.assert_array_equal(invert_pose(c2w[:3]), jax_invert_pose(c2w[:3]))


@pytest.mark.parametrize("use_light_index, subset", [([0], None), (None, 3), ([0], 1), ([0, 14], 4)])
def test_frame_filters_match_jax(scenes, use_light_index, subset):
    """``use_light_index`` (a key no shipped config sets, so it is set on the
    loaded configs) keeps the frames of those lights; ``subset`` picks by
    linspace."""
    cfgs = _configs(scenes, RENE, (27, 36))
    for cfg in cfgs:
        cfg.data.train.use_light_index = use_light_index
        cfg.data.train.subset = subset
    jds = jax_resolve("dataset", "lumen")(cfgs[0])
    tds = resolve("dataset", "lumen")(cfgs[1])
    assert [f["file_path"] for f in tds.list] == [f["file_path"] for f in jds.list]
    if use_light_index:
        assert {f["light_index"] for f in tds.list} <= set(use_light_index)
    if subset:
        assert len(tds.list) == subset


def test_find_idx_cam_light(scenes):
    jds, tds = _datasets(scenes, RENE, (27, 36), is_inference=True)
    idx = tds.find_idx_cam_light("c25l10")
    assert idx is not None and idx == jds.find_idx_cam_light("c25l10")
    assert (tds.list[idx]["camera_index"], tds.list[idx]["light_index"]) == (25, 10)
    assert tds.find_idx_cam_light("c99l99") is None and jds.find_idx_cam_light("c99l99") is None


@pytest.mark.parametrize("config", [RENE, HOTDOG], ids=["rene", "mli"])
def test_find_closest_idx(scenes, config):
    jds, tds = _datasets(scenes, config, SIZES[config]["resized"])
    rng = np.random.default_rng(1)
    for i in range(len(tds)):
        pose = tds.get_camera(i)[1].copy()
        pose[:, 3] += rng.normal(0, 0.01, 3)
        light = tds.get_light(i)
        assert tds.find_closest_idx(pose, light) == jds.find_closest_idx(pose, light) == i
        assert tds.find_closest_idx(pose, None) == jds.find_closest_idx(pose, None)


def test_mli_ground_truth_intrinsics_on_white(scenes):
    """Ref, Sha and Res composited on white with the image's alpha, as the
    JAX package does; the image too."""
    jds, tds = _datasets(scenes, HOTDOG, (16, 16), is_inference=True)
    assert tds.load_iid and tds.white_background
    for i in range(len(tds)):
        want, got = jds.get_full_sample(i), tds.get_full_sample(i)
        for key in ("image", "Ref", "Sha", "Res"):
            assert got[key].dtype == np.float32 and got[key].shape == (16, 16, 3)
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # White where the alpha is 0: the fixture's corners are background.
    assert np.all(tds.get_full_sample(0)["Res"][0, 0] == 1.0)


def test_nrhints_keeps_a_black_background(scenes):
    _, tds = _datasets(scenes, PIKACHU, (24, 24))
    assert tds.data_source == "NRHints" and not tds.white_background
    assert tds._image_path(0).endswith("train/000.png")
    assert tds.get_full_sample(0)["image"][0, 0].max() < 0.05


def _label_store(keys, h, w, layout, rng):
    """A pseudo_label_all store over (camera, light) keys, maps in the
    [C,H,W] (reference .pt) or [H,W,C] layout."""
    def arr(c):
        a = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
        return np.moveaxis(a, -1, 0) if layout == "chw" else a

    store = {}
    for cam, light in keys:
        node = store.setdefault(cam, {"pseudo_reflectance": arr(3)})
        node[light] = {"pseudo_shading_gamma": arr(1), "visibility_certainty": arr(1)}
    return store


@pytest.mark.parametrize("layout", ["chw", "hwc"])
@pytest.mark.parametrize("config", [RENE, HOTDOG], ids=["rene", "mli"])
def test_pseudo_label_arrays_match_jax(scenes, config, layout, tmp_path):
    size = SIZES[config]["resized"]
    _, tds = _datasets(scenes, config, size)
    keys = [tds._pseudo_label_keys(i) for i in range(len(tds))]
    if config == RENE:
        assert keys == [(str(f["camera_index"]), str(f["light_index"])) for f in tds.list]
    else:
        assert keys == [(str(i), "0") for i in range(len(tds))]
    path = str(tmp_path / "pseudo_label_all")
    save_results_all(_label_store(keys, *size, layout, np.random.default_rng(2)), path)
    jds, tds = _datasets(scenes, config, size, f"--data.train.pseudo_label.pt_file={path}.npz", stage="b")
    want, got = jds.as_arrays(), tds.as_arrays()
    _assert_arrays_equal(want, got)
    assert got["pseudo_ref"].shape == (len(tds), *size, 3) and got["pseudo_sha"].shape == (len(tds), *size, 1)


def test_gather_batch_decodes_uint8_like_jax_sample_batch(scenes, tmp_path):
    """JAX's sample_batch draws its picks with jax.random; the port's
    gather_batch takes the same picks and must give the same float32
    pixels, pseudo labels included."""
    size = SIZES[RENE]["resized"]
    _, tds = _datasets(scenes, RENE, size)
    keys = [tds._pseudo_label_keys(i) for i in range(len(tds))]
    path = str(tmp_path / "labels")
    save_results_all(_label_store(keys, *size, "hwc", np.random.default_rng(3)), path)
    jcfg, tcfg = _configs(scenes, RENE, size, f"--data.train.pseudo_label.pt_file={path}.npz",
                          "--data.train.batch_size=2", stage="b")
    arrays = resolve("dataset", tcfg.data.type)(tcfg).as_arrays()
    assert arrays["images"].dtype == np.uint8
    jself = types.SimpleNamespace(cfg=jcfg, num_rand_rays=lambda: 40,
                                  pixel_array_keys=lambda: JaxLumenTrainer.pixel_array_keys(None))
    jbatch = JaxBaseTrainer.sample_batch(jself, {k: jnp.asarray(v) for k, v in arrays.items()},
                                         jax.random.PRNGKey(5))
    tself = types.SimpleNamespace(cfg=tcfg, pixel_array_keys=lambda: LumenTrainer.pixel_array_keys(None))
    tbatch = BaseTrainer.gather_batch(tself, {k: torch.as_tensor(v) for k, v in arrays.items()},
                                      torch.as_tensor(np.array(jbatch["idx"])),
                                      torch.as_tensor(np.array(jbatch["ray_idx"])).long())
    assert tbatch["image_sampled"].dtype == torch.float32
    for key, value in jbatch.items():
        np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(value), err_msg=key)
    assert float(tbatch["image_sampled"].max()) <= 1.0 and float(tbatch["image_sampled"].max()) > 0.1


def test_registry_resolves_the_ports_datasets():
    import mlinerf_tpu_torch.data.blender as blender
    import mlinerf_tpu_torch.data.llff as llff
    import mlinerf_tpu_torch.data.lumen as lumen
    import mlinerf_tpu_torch.data.lumen_blender as lumen_blender
    import mlinerf_tpu_torch.data.synthetic as synthetic

    for name, module in (("synthetic", synthetic), ("lumen", lumen), ("lumen_blender", lumen_blender),
                         ("nerf_blender", blender), ("nerf_llff", llff)):
        assert resolve("dataset", name) is module.Dataset
    with pytest.raises(NotImplementedError, match="dataset type 'dummy' is not ported"):
        resolve("dataset", "dummy")


@pytest.mark.parametrize("config", [RENE, HOTDOG, PIKACHU], ids=["rene", "mli", "nrhints"])
def test_paper_config_trains_one_tiny_step(scenes, config, tmp_path):
    _, tcfg = _configs(scenes, config, SIZES[config]["resized"], "--max_iter=1", "--logging_iter=1",
                       "--checkpoint.save_iter=1000")
    ds = resolve("dataset", tcfg.data.type)(tcfg)
    arrays = ds.as_arrays()
    trainer = resolve("trainer", tcfg.trainer.type)(tcfg, seed=0, logdir=str(tmp_path), device="cpu")
    trainer.train(arrays)
    records = [json.loads(line) for line in open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    assert [r["step"] for r in records] == [1] and np.isfinite(records[0]["train/total_loss"])
    if config == RENE:
        assert tcfg.data.bounding_type == "box"


def test_metrics_cli_scores_against_the_datasets_ground_truth(scenes, tmp_path, monkeypatch):
    """The metrics CLI forces ``load_iid`` on and scores rgb, reflectance and
    shading dumps against the MLI set's composited ground truth, as the JAX
    package's ``evaluate_outputs`` does (within 1e-9; no LPIPS weights)."""
    config = HOTDOG
    from mlinerf_tpu.pipelines import metrics as jax_metrics
    from mlinerf_tpu_torch.pipelines import metrics
    from mlinerf_tpu_torch.utils.image_io import save_image

    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    if metrics.lpips_weights_path() is not None:
        pytest.skip("assets/lpips_alex.npz is present")
    size = SIZES[config]["resized"]
    rng = np.random.default_rng(4)
    out = tmp_path / "output_image"
    jcfg, _ = _configs(scenes, config, size)
    for i in range(len(jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=True))):
        for key in ("rgb_map", "o_r_map", "o_s_map"):
            save_image(str(out / f"{i}_{key}.png"), rng.uniform(0, 1, (*size, 3)).astype(np.float32))
    root, annotations = scenes[config]
    got = metrics.main(["--config", config, "--output_dir", str(out), "--components", "rgb,ref,sha",
                        "--allow_missing_lpips", "--device", "cpu", *TINY_FILES,
                        *dataset_args(root, annotations, size)])
    jcfg.data.val.load_iid = True
    want = jax_metrics.evaluate_outputs(str(out), jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=True),
                                        size, components=("rgb", "ref", "sha"))
    assert sorted(got) == sorted(want) == ["ref", "rgb", "sha"]
    for comp in want:
        assert sorted(got[comp]) == ["mse", "psnr", "ssim"]
        for k in got[comp]:
            assert abs(got[comp][k] - want[comp][k]) <= 1e-9, (comp, k)
