"""Stage b of configs/syn_hotdog_b.yaml scored against the MLI ground
truth (tests/torch_paper.py's MLI layout) in the port and the JAX package
at the TINY size, from one stage-b model: both trainers warm-started from
one JAX stage-a checkpoint, the port then taking the JAX trainer's params
(the ``rgb_r_s`` heads included).

- validation (trainers/base.py ``validate``) on the config's ``subset: 3``:
  ``val/psnr``, ``val/psnr_ref`` and ``val/psnr_sha`` (shading gamma
  1/2.2) against the reflectance and shading images composited on white;
- ``image_test`` (pipelines/inference.py ``test_save``): the same files,
  the ``o_r``, ``o_s`` and ``o_re`` maps among them;
- the metrics CLI's rgb, ref and sha scores of the port's files against
  the JAX package's ``evaluate_outputs`` of its own.

Bounds: 1e-4 dB (measured: at most 2.9e-6 dB in validation; one pixel of
one rgb map one level apart, so 7.6e-6 dB in the rgb score and 0 in ref
and sha).
"""

import json
import os

import jax
import numpy as np
import pytest

from torch_paper import SIZE, datasets, jax_stage_a, layout_configs, write_scenes

from mlinerf_tpu.pipelines import inference as jax_inference
from mlinerf_tpu.pipelines import metrics as jax_metrics
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.pipelines import inference, metrics
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer
from mlinerf_tpu_torch.utils.image_io import read_png

DB_TOL = 1e-4


@pytest.fixture(scope="module")
def stage_b(tmp_path_factory):
    scenes = write_scenes(tmp_path_factory.mktemp("paper"))
    _, pointer = jax_stage_a(scenes, str(tmp_path_factory.mktemp("jax_a")))
    jcfg, tcfg = layout_configs(scenes, "mli", "b", f"--model.use_pre_trained.pt_filename={pointer}")
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax_b")))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("port_b")), device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    jds, tds = datasets(scenes, "mli", "b", is_inference=True)
    return dict(scenes=scenes, jtr=jtr, ttr=ttr, jds=jds, tds=tds, jcfg=jcfg, tcfg=tcfg)


def _last_line(trainer):
    with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
        return json.loads(f.read().splitlines()[-1])


def test_validation_psnr_ref_sha_match_jax(stage_b):
    """The three validation PSNRs of the config's 3 validation frames
    (ground-truth intrinsics loaded: ``load_iid``) within 1e-4 dB."""
    jds, tds = stage_b["jds"], stage_b["tds"]
    assert len(tds) == len(jds) == 3 and tds.load_iid and tds.white_background
    assert stage_b["tcfg"].data.val.subset == 3
    stage_b["jtr"].validate(jds, step=5)
    stage_b["ttr"].validate(tds, step=5)
    want, got = _last_line(stage_b["jtr"]), _last_line(stage_b["ttr"])
    for key in ("val/psnr", "val/psnr_ref", "val/psnr_sha"):
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=DB_TOL, err_msg=key)


@pytest.fixture(scope="module")
def image_test(stage_b, tmp_path_factory):
    out = tmp_path_factory.mktemp("image_test")
    jax_inference.test_save(stage_b["jtr"], stage_b["jds"], str(out / "jax"), image_size=SIZE)
    inference.test_save(stage_b["ttr"], stage_b["tds"], str(out / "port"), image_size=SIZE)
    return out


def test_image_test_files_match_jax(image_test):
    """The same files; each image within one level of JAX's (a render a
    rounding away from a level boundary), nearly all equal."""
    names = sorted(os.listdir(image_test / "port"))
    assert names == sorted(os.listdir(image_test / "jax"))
    for idx in range(3):
        for key in ("rgb_map", "o_r_map", "o_s_map", "o_re_map", "normal_map", "gt"):
            assert f"{idx}_{key}.png" in names, (idx, key)
    differ = 0
    for name in names:
        got, want = read_png(str(image_test / "port" / name)), read_png(str(image_test / "jax" / name))
        assert got.shape == want.shape and got.shape[:2] == SIZE, name
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, name
        differ += int((diff > 0).sum())
    assert differ <= 1e-3 * len(names) * SIZE[0] * SIZE[1] * 3


def test_metrics_ref_sha_match_jax(stage_b, image_test, monkeypatch):
    """The metrics CLI (``load_iid`` forced on, no LPIPS weights) on the
    port's files against ``evaluate_outputs`` of the JAX package on its
    own: rgb, ref and sha PSNR within 1e-4 dB, SSIM and MSE alike."""
    monkeypatch.setenv("LPIPS_WEIGHTS", str(image_test / "absent.npz"))
    got = metrics.main(["--config", "configs/syn_hotdog_b.yaml", "--output_dir", str(image_test / "port"),
                        "--components", "rgb,ref,sha", "--allow_missing_lpips", "--device", "cpu",
                        *stage_b["scenes"]["mli"]])
    jcfg = stage_b["jcfg"]
    jcfg.data.val.load_iid = True
    want = jax_metrics.evaluate_outputs(str(image_test / "jax"), stage_b["jds"], SIZE,
                                        components=("rgb", "ref", "sha"))
    assert sorted(got) == sorted(want) == ["ref", "rgb", "sha"]
    for comp in want:
        assert sorted(got[comp]) == ["mse", "psnr", "ssim"]
        assert np.isfinite(got[comp]["psnr"])
        np.testing.assert_allclose(got[comp]["psnr"], want[comp]["psnr"], rtol=0, atol=DB_TOL, err_msg=comp)
        for key in ("mse", "ssim"):
            np.testing.assert_allclose(got[comp][key], want[comp][key], rtol=1e-4, err_msg=f"{comp}/{key}")
