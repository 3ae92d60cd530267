"""The port's counterparts of the shell scripts, each in one process on the
CPU at the TINY size with 16x16 images: ``run_real`` (run_real.sh) on an
NRHints fixture, ``run_synthetic`` (run_synthetic.sh) with
configs/syn_hotdog_{a,b}.yaml on an MLI fixture, and ``run_rene``
(run_rene.sh) on a ReNe fixture; and the scripts' render flags
(``--model.render.rand_rays_val=4096
--runtime.inference_chunks_per_dispatch=4``), which reach the render step
unless the caller overrides the same key."""

import contextlib
import functools
import io
import json
import os

import pytest

from torch_parity import TINY_FILES, dataset_args, pil_save

from mlinerf_tpu_torch import run_real, run_rene, run_synthetic
from mlinerf_tpu_torch import test as test_cli
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.pipelines import chain, inference

SIZE = ["--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]"]
STEPS = ["--max_iter=2", "--logging_iter=1", "--validation_iter=2"]
FIVE = ["train_a", "render_a", "pseudo_label", "train_b", "image_test_b"]


def _run(main, argv, monkeypatch):
    """``main(argv)`` quietly; returns its result and the trainer of each
    ``test`` step in order."""
    trainers, test_main = [], test_cli.main
    monkeypatch.setattr(test_cli, "main", lambda args: trainers.append(test_main(args)) or trainers[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        result = main(argv)
    return result, trainers


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for source in ("nrhints", "mli"):
        annotations = fixtures.write_point_light(str(root / source), image_size=24, train=4, val=2, lights=2,
                                                 source=source, seed=4, save=pil_save)
        out[source] = dataset_args(str(root / source), annotations)
    rene = fixtures.write_rene(str(root / "rene"), "dataset_rene/savannah", cameras=2, lights=2,
                               raw_size=(144, 108), extra_splits={"test_custom": 2}, save=pil_save)
    out["rene"] = dataset_args(str(root / "rene"), rene)
    return out


def test_run_real_runs_the_nrhints_chain(scenes, tmp_path, monkeypatch):
    """run_real.sh's five steps on NRHints_Pikachu_{a,b}: the unpair renders
    and labels, stage b and image_test; no metrics step (the captures have
    no Ref/Sha/Res); the step seconds in ``run_real.json``. Without a
    caller's override the render reads the script's flags."""
    tiny = [a for a in TINY_FILES if not a.startswith("--model.render.rand_rays_val")]
    result, trainers = _run(run_real.main, ["--logroot", str(tmp_path), "--device", "cpu", *STEPS, *tiny, *SIZE,
                                            *scenes["nrhints"]], monkeypatch)
    assert list(result["seconds"]) == FIVE and "scores" not in result
    assert (result["conf_a"], result["conf_b"]) == ("configs/NRHints_Pikachu_a.yaml", "configs/NRHints_Pikachu_b.yaml")
    assert (result["render_mode"], result["setting"]) == ("unpairlights_train", "unpair")
    written = json.load(open(tmp_path / "NRHints_Pikachu_b" / "run_real.json"))
    assert written["seconds"] == result["seconds"]
    render = trainers[0].cfg
    assert render.data.data_source == "NRHints" and not render.data.white_background
    assert (render.model.render.rand_rays_val, render.runtime.inference_chunks_per_dispatch) == (4096, 4)
    assert trainers[1].cfg.model.render.rand_rays_val == 8192  # image_test: the config's own
    labels = tmp_path / "NRHints_Pikachu_a" / "output_unpairlights_train_pseudo_label" / "pseudo_label_all.npz"
    assert labels.exists()
    names = os.listdir(tmp_path / "NRHints_Pikachu_b" / "output_image")
    assert {"0_o_r_map.png", "0_o_s_map.png", "1_o_re_map.png"} <= set(names)
    assert "val/psnr" in result["last_validation"]["b"] and "val/psnr_ref" not in result["last_validation"]["b"]


def test_run_synthetic_runs_the_hotdog_chain_and_its_metrics(scenes, tmp_path, monkeypatch):
    """run_synthetic.sh's steps with CONF_a=syn_hotdog_a, then the metrics
    against the MLI ground truth; a caller's ``rand_rays_val`` replaces the
    script's, the other render flag stays."""
    result, trainers = _run(run_synthetic.main, [
        "--conf_a", "configs/syn_hotdog_a.yaml", "--conf_b", "configs/syn_hotdog_b.yaml", "--logroot", str(tmp_path),
        "--device", "cpu", *STEPS, *TINY_FILES, *SIZE, *scenes["mli"]], monkeypatch)
    assert list(result["seconds"]) == FIVE + ["metrics_b"]
    assert sorted(result["scores"]) == ["ref", "rgb", "sha"]
    written = json.load(open(tmp_path / "syn_hotdog_b" / "run_synthetic.json"))
    assert written["scores"] == result["scores"]
    render = trainers[0].cfg
    assert (render.model.render.rand_rays_val, render.runtime.inference_chunks_per_dispatch) == (512, 4)
    assert "val/psnr_ref" in result["last_validation"]["b"] and "val/psnr_sha" in result["last_validation"]["b"]


def test_run_rene_runs_the_rene_chain(scenes, tmp_path, monkeypatch):
    """run_rene.sh's steps: the pair renders and labels, stage b,
    image_test on test_custom_transforms.json and the video (frames 0 to 3
    here, its 60 renders cut to 4)."""
    monkeypatch.setattr(inference, "test_video", functools.partial(inference.test_video, num_frames=4))
    monkeypatch.setattr(run_rene, "VIDEO", "video_train_0_3")  # the fixture has no frame 67
    result, trainers = _run(run_rene.main, ["--logroot", str(tmp_path), "--device", "cpu", *STEPS, *TINY_FILES,
                                            "--data.train.image_size=[18,24]", "--data.val.image_size=[18,24]",
                                            *scenes["rene"]], monkeypatch)
    assert list(result["seconds"]) == FIVE + ["video_b"]
    assert (result["render_mode"], result["setting"]) == ("lights_train", "pair")
    assert json.load(open(tmp_path / "rene_savannah_b" / "run_rene.json"))["seconds"] == result["seconds"]
    assert len(trainers) == 3 and trainers[0].cfg.runtime.inference_chunks_per_dispatch == 4
    assert trainers[1].cfg.data.val.annotation.endswith("test_custom_transforms.json")
    assert (tmp_path / "rene_savannah_a" / "output_lights_train_pseudo_label" / "pseudo_label_all.npz").exists()
    assert (tmp_path / "rene_savannah_b" / "output_video_train" / "video_0_3.apng").exists()


@pytest.mark.parametrize("overrides,want", [
    ([], list(chain.RENDER_FLAGS)),
    (["--max_iter=2"], [*chain.RENDER_FLAGS, "--max_iter=2"]),
    (["--model.render.rand_rays_val=512"], ["--runtime.inference_chunks_per_dispatch=4",
                                            "--model.render.rand_rays_val=512"]),
    (["--runtime.inference_chunks_per_dispatch=auto", "--model.render.rand_rays_val=64"],
     ["--runtime.inference_chunks_per_dispatch=auto", "--model.render.rand_rays_val=64"]),
], ids=["none", "other_key", "one", "both"])
def test_caller_override_replaces_the_script_flag(overrides, want):
    assert chain.with_overrides(chain.RENDER_FLAGS, overrides) == want
    assert chain.override_key("--a.b!") == chain.override_key("--a.b") == chain.override_key("--a.b=1") == "a.b"
