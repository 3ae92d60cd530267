"""The JAX package's fast-path configs through the port's CLIs on the CPU
at the TINY size: configs/syn_e2e_a.yaml trains and renders, syn_e2e_b.yaml
warm-starts from it and trains, syn_hotdog_tpu_a.yaml (steps_per_dispatch
32, accepted and ignored) trains on an MLI fixture; every opt-in knob of
configs/base_sdf.yaml builds; and ``optim.lr_scales`` against optax."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, TINY_FILES, configs, dataset_args, pil_save

from mlinerf_tpu.trainers.optim import make_optimizer as jax_make_optimizer
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.trainers.optim import make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One camera under one light, 16x16.
SMALL = [a for a in TINY if not a.startswith("--data.")] + [
    "--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]", "--data.num_cameras=1",
    "--data.num_lights=1"]


def _run(module, *args):
    cmd = [sys.executable, "-m", f"mlinerf_tpu_torch.{module}", "--device", "cpu", *args]
    return subprocess.run(cmd, cwd=ROOT, check=True, timeout=300, capture_output=True, text=True).stdout


def _records(logdir):
    return [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]


def test_syn_e2e_chain_through_the_clis(tmp_path):
    """Stage a on syn_e2e_a (3 steps), a light render from its checkpoint,
    then stage b on syn_e2e_b warm-started from it (no pseudo labels: the
    intrinsic loss drops out; the SDF is frozen)."""
    a, b = tmp_path / "a", tmp_path / "b"
    _run("train", "--config", "configs/syn_e2e_a.yaml", "--logdir", str(a), "--max_iter=3", "--logging_iter=1",
         *SMALL)
    assert [r["step"] for r in _records(a)] == [1, 2, 3]
    assert all(np.isfinite(r["train/total_loss"]) and r["train/table_grad_norm"] >= 0 for r in _records(a))
    _run("test", "--config", "configs/syn_e2e_a.yaml", "--logdir", str(a), "--inference_mode", "lights_train",
         *SMALL)
    assert (a / "output_lights_train" / "results_all.npz").exists()
    out = _run("train", "--config", "configs/syn_e2e_b.yaml", "--logdir", str(b), "--max_iter=2", "--logging_iter=1",
               *SMALL, f"--model.use_pre_trained.pt_filename={a / 'latest_checkpoint.txt'}",
               "--data.train.pseudo_label.enabled!")
    assert "[optim] partial training on ['neural_rgb']" in out
    records = _records(b)
    assert [r["step"] for r in records] == [1, 2] and all(np.isfinite(r["train/total_loss"]) for r in records)
    assert all(r["train/table_grad_norm"] == 0 for r in records)


def test_syn_hotdog_tpu_a_trains_on_an_mli_fixture(tmp_path):
    annotations = fixtures.write_point_light(str(tmp_path / "mli"), image_size=16, train=2, val=1, lights=2,
                                             save=pil_save)
    logdir = tmp_path / "run"
    _run("train", "--config", "configs/syn_hotdog_tpu_a.yaml", "--logdir", str(logdir), "--max_iter=2",
         "--logging_iter=1", *TINY_FILES, *dataset_args(str(tmp_path / "mli"), annotations, (16, 16)),
         "--model.object.sdf.encoding.coarse2fine.enabled!")
    records = _records(logdir)
    assert [r["step"] for r in records] == [1, 2] and all(np.isfinite(r["train/total_loss"]) for r in records)


KNOBS = {
    "shared_levels_int": ["--model.object.sdf.gradient.shared_levels=2"],
    "shared_levels_auto": ["--model.object.sdf.gradient.shared_levels=auto"],
    "hessian_exact": ["--model.object.sdf.gradient.shared_levels=4", "--model.object.sdf.gradient.hessian.mode=exact"],
    "dense_blocked": ["--model.object.sdf.encoding.hashgrid.dense_blocked"],
    "sampling_levels": ["--model.render.sampling_levels=2"],
    "corner_sample": ["--model.object.sdf.gradient.corner_sample.enabled"],
    "subsample": ["--model.object.sdf.gradient.subsample.enabled"],
    "occupancy": ["--model.render.occupancy.enabled", "--model.render.occupancy.resolution=8"],
    "lr_scales": [],  # set below: the config has no such key to override
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_each_knob_builds_and_steps(knob, tmp_path):
    """Each opt-in knob of configs/base_sdf.yaml builds a trainer (no
    NotImplementedError) and takes a finite training step."""
    from mlinerf_tpu_torch.data.synthetic import Dataset
    from mlinerf_tpu_torch.trainers.lumen import Trainer

    _, cfg = configs(*KNOBS[knob], "--max_iter=1", "--logging_iter=1")
    if knob == "lr_scales":
        cfg.optim.lr_scales = {"hash_table": 2.0}
    tr = Trainer(cfg, seed=0, logdir=str(tmp_path), device="cpu")
    info = tr.train(Dataset(cfg).as_arrays())
    assert np.isfinite(float(info["total"]))


def test_lr_scales_match_optax():
    """``optim.lr_scales: {hash_table: 4.0, linear_0: 0.5}`` on a bf16 table,
    a float32 layer matching the second keyword and one matching none:
    three updates against optax's chained masked scales, to one bf16 ulp
    and float32 rounding."""
    jcfg, tcfg = configs("--optim.sched.warm_up_end=2")
    for cfg in (jcfg, tcfg):
        cfg.optim.lr_scales = {"hash_table": 4.0, "linear_0": 0.5}
    rng = np.random.default_rng(3)
    leaves = {"hash_table": jnp.asarray(rng.uniform(-1e-4, 1e-4, (512, 8)), jnp.bfloat16),
              "linear_0": jnp.asarray(rng.normal(0, 0.3, (64, 32)), jnp.float32),
              "linear_1": jnp.asarray(rng.normal(0, 0.3, (32, 16)), jnp.float32)}
    tx, _ = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter)
    state = tx.init(leaves)
    names = list(leaves)
    tparams = [torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16 if v.dtype == jnp.bfloat16
                                                             else torch.float32) for v in leaves.values()]
    opt, _ = make_optimizer(tcfg.optim, tparams, names=names)
    assert opt.update_scales == [(4.0,), (0.5,), ()]
    for _ in range(3):
        grads = {k: jnp.asarray(rng.normal(0, 1e-2, v.shape), v.dtype) for k, v in leaves.items()}
        updates, state = tx.update(grads, state, leaves)
        leaves = jax.tree.map(lambda p, u: p + u.astype(p.dtype), leaves, updates)
        opt.step([torch.from_numpy(np.array(grads[k], np.float32)).to(p.dtype) for k, p in zip(names, tparams)])
    for k, p in zip(names, tparams):
        want = torch.from_numpy(np.array(leaves[k], np.float32))
        if p.dtype == torch.bfloat16:
            assert torch.all((p.float() - want).abs() <= torch.finfo(torch.bfloat16).eps * want.abs()), k
        else:
            np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="names"):
        make_optimizer(tcfg.optim, tparams)
