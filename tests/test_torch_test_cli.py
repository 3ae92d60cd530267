"""The port's CLIs on the CPU: ``python -m mlinerf_tpu_torch.train`` trains,
validates and writes checkpoints; ``python -m mlinerf_tpu_torch.test``
loads the latest one and renders ``image_test`` and ``unpairlights_train``.
Without ``--device cpu`` the inference CLI asks for CUDA and raises here;
the modes that are not ported raise ``NotImplementedError``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import CONFIG, TINY

from mlinerf_tpu_torch import test as test_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [a for a in TINY if "image_size" not in a] + ["--data.train.image_size=[16,16]",
                                                     "--data.val.image_size=[16,16]"]


def _run(module, *args):
    cmd = [sys.executable, "-m", module, "--config", CONFIG, *args, *SMALL]
    return subprocess.run(cmd, cwd=ROOT, check=True, timeout=300, capture_output=True, text=True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("cli") / "run"
    _run("mlinerf_tpu_torch.train", "--logdir", str(logdir), "--device", "cpu", "--max_iter=2",
         "--logging_iter=1", "--validation_iter=2", "--checkpoint.save_iter=1")
    return logdir


def test_train_cli_validates_and_saves(trained):
    names = sorted(os.listdir(trained))
    assert "epoch_00000_iteration_000000001_checkpoint.pkl" in names
    assert "epoch_00000_iteration_000000002_checkpoint.pkl" in names
    # The end of the run saves the last state as ``latest``.
    assert "latest_checkpoint.pkl" in names
    assert (trained / "latest_checkpoint.txt").read_text() == "latest_checkpoint.pkl\n"
    records = [json.loads(line) for line in (trained / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if "val/psnr" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["val/psnr"])


def test_image_test_cli(trained):
    _run("mlinerf_tpu_torch.test", "--logdir", str(trained), "--device", "cpu", "--inference_mode", "image_test")
    names = os.listdir(trained / "output_image")
    for key in ("rgb_map", "normal_map", "depth_map", "opacity_map", "gt"):
        assert f"0_{key}.png" in names, key


def test_unpairlights_train_cli(trained):
    out = _run("mlinerf_tpu_torch.test", "--logdir", str(trained), "--device", "cpu",
               "--inference_mode", "unpairlights_train")
    assert "(iteration 2)" in out.stdout
    out_dir = trained / "output_unpairlights_train"
    with np.load(out_dir / "results_all.npz") as data:
        keys = sorted(data.files)
        # 2 cameras x 2 lights = 4 frames, each under 4 lights, 5 maps each.
        assert len(keys) == 4 * 4 * 5
        assert all(np.isfinite(data[k]).all() for k in keys)
        assert data["0||1||visibility"].shape == (1, 16, 16, 1)


def test_inference_cli_asks_for_cuda(trained):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main(["--config", CONFIG, "--logdir", str(trained), "--inference_mode", "image_test", *SMALL])


@pytest.mark.parametrize("mode", ["rene_test", "video_test_0_1"])
def test_unported_modes_raise(mode, trained):
    with pytest.raises(NotImplementedError, match=mode.split("_")[0]):
        test_cli.main(["--config", CONFIG, "--logdir", str(trained), "--device", "cpu", "--inference_mode", mode,
                       *SMALL])
