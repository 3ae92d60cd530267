"""The port's whole two-stage pipeline through its own entry points on the
CPU, at the TINY size with 16x16 images: ``train`` (stage a), ``test
--inference_mode unpairlights_train``, ``pipelines.pseudo_label``, ``train``
(stage b: warm start, partial training, pseudo labels) and ``test
--inference_mode image_test``. Without ``--device`` the pseudo-label CLI
asks for CUDA and raises here."""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_parity import TINY

from mlinerf_tpu_torch.pipelines import pseudo_label
from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [a for a in TINY if "image_size" not in a] + ["--data.train.image_size=[16,16]",
                                                     "--data.val.image_size=[16,16]"]


def _run(module, *args):
    cmd = [sys.executable, "-m", module, *args]
    return subprocess.run(cmd, cwd=ROOT, check=True, timeout=300, capture_output=True, text=True)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    a, b = root / "a", root / "b"
    renders = a / "output_unpairlights_train"
    labels = str(renders) + "_pseudo_label"
    _run("mlinerf_tpu_torch.train", "--config", "configs/syn_sphere_a.yaml", "--logdir", str(a), "--device", "cpu",
         "--max_iter=3", "--logging_iter=1", *SMALL)
    _run("mlinerf_tpu_torch.test", "--config", "configs/syn_sphere_a.yaml", "--logdir", str(a), "--device", "cpu",
         "--inference_mode", "unpairlights_train", *SMALL)
    _run("mlinerf_tpu_torch.pipelines.pseudo_label", "--workdir", str(renders), "--setting", "unpair",
         "--device", "cpu")
    out_b = _run("mlinerf_tpu_torch.train", "--config", "configs/syn_sphere_b.yaml", "--logdir", str(b),
                 "--device", "cpu", "--max_iter=3", "--logging_iter=1", *SMALL,
                 f"--model.use_pre_trained.pt_filename={a / 'latest_checkpoint.txt'}",
                 f"--data.train.pseudo_label.pt_file={labels}/pseudo_label_all.npz")
    _run("mlinerf_tpu_torch.test", "--config", "configs/syn_sphere_b.yaml", "--logdir", str(b), "--device", "cpu",
         "--inference_mode", "image_test", *SMALL)
    return dict(a=a, b=b, renders=renders, labels=labels, stdout_b=out_b.stdout)


def test_pseudo_labels_written(pipeline):
    path = os.path.join(pipeline["labels"], "pseudo_label_all.npz")
    assert os.path.exists(path)
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all

    store = load_results_all(path)
    # 2 cameras x 2 lights = 4 frames, each under 4 lights.
    assert sorted(store) == ["0", "1", "2", "3"]
    assert store["0"]["pseudo_reflectance"].shape == (16, 16, 3)
    assert store["3"]["2"]["pseudo_shading_gamma"].shape == (16, 16, 1)


def test_stage_b_logs_intrinsic_losses(pipeline):
    records = [json.loads(line) for line in (pipeline["b"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    for key in ("intrinsic", "regularize_re", "render", "eikonal", "curvature"):
        assert all(f"train/loss/{key}" in r for r in records), key
    assert "[warm-start] loaded" in pipeline["stdout_b"] and "mlp_r" in pipeline["stdout_b"]
    assert "[optim] partial training on ['neural_rgb']" in pipeline["stdout_b"]


def test_stage_b_keeps_the_sdf_of_stage_a(pipeline):
    """Every parameter outside the radiance heads is bitwise stage a's; the
    heads moved; the optimizer state covers the heads only."""
    a = Checkpointer.load_file(str(pipeline["a"] / "latest_checkpoint.txt"))["state"]
    b = Checkpointer.load_file(str(pipeline["b"] / "latest_checkpoint.txt"))["state"]
    assert b["iteration"] == 3
    frozen = [k for k in b["params"] if not k.startswith("neural_rgb.")]
    assert any(k.startswith("neural_sdf.hash_table.") for k in frozen) and "s_var" in frozen
    for k in frozen:
        assert torch.equal(b["params"][k], a["params"][k]), k
    assert not torch.equal(b["params"]["neural_rgb.mlp.linear_0.weight"], a["params"]["neural_rgb.mlp.linear_0.weight"])
    heads = [k for k in b["params"] if k.startswith("neural_rgb.")]
    assert len(b["opt_state"]["mu"]) == len(heads)


def test_image_test_writes_intrinsic_maps(pipeline):
    names = os.listdir(pipeline["b"] / "output_image")
    for key in ("rgb_map", "o_r_map", "o_s_map", "o_re_map", "normal_map"):
        assert f"0_{key}.png" in names, key


def test_pseudo_label_cli_asks_for_cuda(pipeline):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pseudo_label.main(["--workdir", str(pipeline["renders"]), "--setting", "unpair"])
