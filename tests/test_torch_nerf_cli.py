"""The NeRF family through the port's entry points on the CPU (``--device
cpu``), at TINY size: ``nerf_synthetic_low`` on the procedural scene and
``nerf_blender``, ``ingp_blender`` and ``nerf_llff`` on their stand-ins
(data/fixtures.py) each go train (with a validation) -> checkpoint ->
``test --inference_mode image_test`` -> the metrics CLI. Also: the trainer
takes bf16 from ``trainer.amp_config`` for these models and the SDF ones, and without
``--device cpu`` the CLI asks for CUDA."""

import json
import math
import os

import numpy as np
import pytest
import torch

from torch_parity import INGP_TINY, NERF_TINY, TINY

from mlinerf_tpu_torch import test as test_cli
from mlinerf_tpu_torch import train as train_cli
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.pipelines import metrics
from mlinerf_tpu_torch.trainers.base import outputs_to_maps

LOW = "configs/nerf_synthetic_low.yaml"
BLENDER = "configs/nerf_blender.yaml"
INGP = "configs/ingp_blender.yaml"
LLFF = "configs/nerf_llff.yaml"


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerf_cli_scenes")
    fixtures.write_nerf_synthetic(str(root / "lego"), image_size=64, train=3, val=2, render_div=2)
    fixtures.write_llff(str(root / "fern"), raw_size=(64, 48), render_div=2)
    return {BLENDER: str(root / "lego"), INGP: str(root / "lego"), LLFF: str(root / "fern")}


def _args(scenes, config):
    tiny = INGP_TINY if config == INGP else NERF_TINY
    size = "[12,16]" if config == LLFF else "[16,16]"
    args = [a for a in tiny if "image_size" not in a] + [f"--data.train.image_size={size}",
                                                         f"--data.val.image_size={size}", "--data.num_workers=2"]
    if config == LOW:
        return args + ["--data.num_cameras=2"]
    return args + [f"--data.root={scenes[config]}", "--data.val.subset=2"]


@pytest.mark.parametrize("config", [LOW, BLENDER, INGP, LLFF],
                         ids=["nerf_synthetic_low", "nerf_blender", "ingp_blender", "nerf_llff"])
def test_train_checkpoint_image_test_metrics(scenes, config, tmp_path, monkeypatch):
    logdir = str(tmp_path / "run")
    args = _args(scenes, config)
    trainer = train_cli.main(["--config", config, "--device", "cpu", "--logdir", logdir, "--max_iter=2",
                              "--logging_iter=1", "--validation_iter=2", "--checkpoint.save_iter=2", *args])
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    steps = [r for r in records if "train/total_loss" in r]
    assert [r["step"] for r in steps] == [1, 2] and all(np.isfinite(r["train/total_loss"]) for r in steps)
    fine = trainer.cfg.model.fine_sampling
    assert ("train/loss/render_fine" in steps[0]) == fine and "train/psnr" in steps[0]
    assert any("val/psnr" in r and np.isfinite(r["val/psnr"]) for r in records)
    assert trainer.compute_dtype == (torch.bfloat16 if config != LOW else torch.float32)
    assert os.path.exists(os.path.join(logdir, "latest_checkpoint.txt"))

    rendered = test_cli.main(["--config", config, "--device", "cpu", "--logdir", logdir,
                              "--inference_mode", "image_test", *args])
    assert rendered.current_iteration == 2
    # rgb_map is the coarse rgb even with fine sampling on, as in the JAX package.
    sample = resolve("dataset", rendered.cfg.data.type)(rendered.cfg, is_inference=True)[0]
    data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
    size = rendered.cfg.data.val.image_size
    out = rendered.render_image(data, size)
    maps = outputs_to_maps(out, data, size)
    np.testing.assert_array_equal(maps["rgb_map"], out["rgb"].reshape(1, *size, 3))
    assert ("rgb_fine" in out) == fine and sorted(k for k in maps) == ["depth_map", "opacity_map", "rgb_map"]
    out = os.path.join(logdir, "output_image")
    for idx in range(2):
        for key in ("rgb_map", "depth_map", "opacity_map", "gt"):
            assert os.path.exists(os.path.join(out, f"{idx}_{key}.png")), (idx, key)

    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    scores = metrics.main(["--config", config, "--output_dir", out, "--allow_missing_lpips", "--device", "cpu",
                           *args])
    assert sorted(scores["rgb"]) == ["mse", "psnr", "ssim"]
    assert all(np.isfinite(v) for v in scores["rgb"].values())


def test_amp_is_carried_by_the_nerf_family_only(tmp_path):
    """``trainer.amp_config.enabled`` gives bf16 MLPs with float32
    parameters for nerf and ingp, and for the SDF models: the Lumen
    and neuralangelo trainers build with bf16 MLPs (float32 parameters
    beside the bf16 tables) and take a training step with a finite loss
    and gradient in the tables (with the encoding's columns of the first
    SDF layer opened: geometric init closes them)."""
    cfg = Config(BLENDER, cli_args=NERF_TINY)
    trainer = resolve("trainer", "nerf")(cfg, seed=0, logdir=str(tmp_path), device="cpu")
    assert trainer.model.nerf.mlp_feat.linear_0.compute_dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    for extra in ([], ["--model.type=neuralangelo", "--trainer.type=neuralangelo"]):
        sdf_cfg = Config("configs/syn_sphere_a.yaml", cli_args=TINY + ["--trainer.amp_config.enabled"]
                         + extra)
        sdf_trainer = resolve("trainer", sdf_cfg.trainer.type)(sdf_cfg, seed=0, logdir=str(tmp_path / "sdf"),
                                                               device="cpu")
        model = sdf_trainer.model
        assert model.neural_sdf.mlp.linear_sdf.compute_dtype == model.neural_rgb.mlp.linear_0.compute_dtype \
            == torch.bfloat16
        assert {p.dtype for n, p in model.named_parameters() if ".hash_table." not in n} == {torch.float32}
        arrays = resolve("dataset", sdf_cfg.data.type)(sdf_cfg).as_arrays()
        with torch.no_grad():
            model.neural_sdf.mlp.linear_0.weight[:, 3:].normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
        info = sdf_trainer.train_step(sdf_trainer.sample_batch({k: torch.as_tensor(v) for k, v in arrays.items()}))
        assert math.isfinite(float(info["total"])) and float(info["table_grad_norm"]) > 0


def test_cli_asks_for_cuda_by_default(scenes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--config", BLENDER, "--logdir", str(tmp_path), "--max_iter=1",
                        *_args(scenes, BLENDER)])
