"""The port's checkpoints and inference (mlinerf_tpu_torch/trainers,
pipelines) against the JAX package's, at 16x16 images: the port's own
checkpoint round trip, a JAX package checkpoint loaded by the port, the
pseudo-label renders (``test_all_light``) and validation PSNR of both
packages from that one checkpoint, the JAX pseudo-label step on the port's
``results_all.npz``, and ``test_save``'s file names."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, perturb_jax_params

from mlinerf_tpu.data.synthetic import Dataset as JaxDataset
from mlinerf_tpu.pipelines import inference as jax_inference
from mlinerf_tpu.pipelines.label_store import load_results_all as jax_load_results_all
from mlinerf_tpu.pipelines.pseudo_label import generate_pseudo_labels
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.pipelines import inference as torch_inference
from mlinerf_tpu_torch.pipelines.label_store import load_results_all
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

SMALL = ["--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]",
         "--model.render.rand_rays_val=128"]
# Past the warm-up, so the checkpoint's iteration moves the normal epsilon
# (coarse-to-fine anneal level 2) and the NeuS cosine anneal.
ITERATION = 700
BOOLEAN = ("visibility", "inter_mask")
CONTINUOUS = ("rgb_render", "normal", "normal_x_light")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX package checkpoint at ITERATION with perturbed params, loaded
    back by a JAX inference trainer, and the configs of both packages."""
    jcfg, tcfg = configs(*SMALL)
    logdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jtr = JaxTrainer(jcfg, is_inference=True, seed=0, logdir=logdir)
    params = perturb_jax_params(jtr.state.params, np.random.default_rng(0))
    # A fifth of the perturbation keeps surfaces the traces converge on.
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"][3:] *= 0.2
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    jtr.save_checkpoint(iteration=ITERATION)
    jtr.checkpointer.wait()
    jtr.current_iteration = 0
    assert jtr.load_checkpoint(os.path.join(logdir, "latest_checkpoint.txt"), resume=False, load_opt=False)
    assert jtr.current_iteration == ITERATION
    return dict(jtr=jtr, jcfg=jcfg, tcfg=tcfg, logdir=logdir, params=params)


@pytest.fixture(scope="module")
def port_trainer(jax_run, tmp_path_factory):
    ttr = TorchTrainer(jax_run["tcfg"], is_inference=True, seed=0,
                       logdir=str(tmp_path_factory.mktemp("port")), device="cpu")
    assert ttr.load_checkpoint(os.path.join(jax_run["logdir"], "latest_checkpoint.txt"))
    return ttr


def test_port_checkpoint_round_trip(tmp_path):
    """Two train steps save a checkpoint by ``save_iter`` under the JAX
    package's file names; an inference trainer loads its params bitwise
    (bf16 tables included) and takes its iteration; a resume also restores
    the optimizer's moments and count."""
    _, tcfg = configs(*SMALL, "--max_iter=2", "--checkpoint.save_iter=2")
    logdir = str(tmp_path)
    ttr = TorchTrainer(tcfg, seed=0, logdir=logdir, device="cpu")
    ttr.train(TorchDataset(tcfg).as_arrays())
    name = "epoch_00000_iteration_000000002_checkpoint.pkl"
    assert sorted(os.listdir(logdir)) == sorted([name, "latest_checkpoint.txt", "metrics.jsonl"])
    assert open(os.path.join(logdir, "latest_checkpoint.txt")).read() == name + "\n"

    inf = TorchTrainer(tcfg, is_inference=True, seed=1, logdir=logdir, device="cpu")
    assert inf.load_checkpoint()
    assert inf.current_iteration == 2
    want = ttr.model.state_dict()
    got = inf.model.state_dict()
    assert any(v.dtype == torch.bfloat16 for v in want.values())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    resumed = TorchTrainer(tcfg, seed=1, logdir=logdir, device="cpu")
    assert resumed.load_checkpoint(resume=True)
    assert resumed.current_iteration == 2 and resumed.optimizer.count == ttr.optimizer.count
    for mine, theirs in zip(resumed.optimizer.mu + resumed.optimizer.nu, ttr.optimizer.mu + ttr.optimizer.nu):
        assert torch.equal(mine, theirs)
    # A warm start (no resume, not inference) keeps iteration 0.
    warm = TorchTrainer(tcfg, seed=1, logdir=logdir, device="cpu")
    assert warm.load_checkpoint(os.path.join(logdir, name)) and warm.current_iteration == 0


def test_jax_checkpoint_loads_into_port(jax_run, port_trainer):
    """The JAX package's pickle: params bitwise through the bridge (bf16
    tables stay bf16), the iteration carried into inference."""
    assert port_trainer.current_iteration == ITERATION
    want = params_from_jax(jax_run["params"])
    got = port_trainer.model.state_dict()
    assert sorted(got) == sorted(want)
    assert any(v.dtype == torch.bfloat16 for v in want.values())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_all_light_unpair_matches_jax_and_feeds_pseudo_labels(jax_run, port_trainer, tmp_path):
    """Both packages render every (frame, light) pair that ``unpair`` picks
    (4 frames x 4 lights) from the same JAX checkpoint. Booleans: at most 1%
    of the pixels of a render differ (measured: 0 of 256 in each of the 16
    renders). Continuous maps on the pixels whose booleans agree: within
    1e-4 (measured: 6.4e-5 in ``normal_x_light``, 4.6e-5 in ``normal``,
    3.5e-5 in ``rgb_render``; the tables are bf16 here). The JAX pseudo-label step then reads the port's
    ``results_all.npz`` as it is."""
    jtr = jax_run["jtr"]
    want = jtr.test_all_light(JaxDataset(jax_run["jcfg"]), str(tmp_path / "jax"), dataset_type="unpair",
                              sample_num=4, seed=999, save_pngs=False)
    out_dir = str(tmp_path / "port")
    got = port_trainer.test_all_light(TorchDataset(jax_run["tcfg"]), out_dir, dataset_type="unpair",
                                      sample_num=4, seed=999)
    assert sorted(got) == sorted(want) == ["0", "1", "2", "3"]
    for cam in want:
        assert sorted(got[cam]) == sorted(want[cam]) == ["0", "1", "2", "3"]
        for light in want[cam]:
            w, g = want[cam][light], got[cam][light]
            assert sorted(g) == sorted(w)
            agree = np.ones(w["visibility"].shape, bool)
            for key in BOOLEAN:
                differ = g[key] != w[key]
                assert differ.sum() <= 0.01 * differ.size, (cam, light, key, int(differ.sum()))
                agree &= ~differ
            for key in CONTINUOUS:
                assert g[key].shape == w[key].shape
                mask = np.broadcast_to(agree[..., :1], g[key].shape)
                np.testing.assert_allclose(g[key][mask], w[key][mask], rtol=0, atol=1e-4,
                                           err_msg=f"{cam}/{light}/{key}")
    assert any(w["visibility"].any() and not w["visibility"].all() for c in want.values() for w in c.values())
    assert sorted(os.listdir(os.path.join(out_dir, "0"))) == sorted(
        [f"0_{k}.png" for k in ("rgb_target", "rgb_render", "normal", "visibility", "inter_mask",
                                "normal_x_light", "pseudo_shading", "inter_dist")]
        + [f"{li}_{k}.png" for li in (1, 2, 3) for k in ("rgb_render", "normal", "visibility", "inter_mask",
                                                          "normal_x_light", "pseudo_shading", "inter_dist")])

    # The port's file, read by both packages' loaders and by the JAX
    # pseudo-label step.
    path = os.path.join(out_dir, "results_all")
    from_jax_loader = jax_load_results_all(path)
    from_port_loader = load_results_all(path)
    for cam in got:
        for light in got[cam]:
            for key, value in got[cam][light].items():
                np.testing.assert_array_equal(from_jax_loader[cam][light][key], value)
                np.testing.assert_array_equal(from_port_loader[cam][light][key], value)
    labels = generate_pseudo_labels(from_jax_loader, setting="unpair")
    H, W = jax_run["tcfg"].data.val.image_size
    for cam in got:
        assert labels[cam]["pseudo_reflectance"].shape == (H, W, 3)
        assert np.isfinite(labels[cam]["pseudo_reflectance"]).all()
        for light in got[cam]:
            assert np.isfinite(labels[cam][light]["pseudo_shading_gamma"]).all()


def test_validate_psnr_matches_jax(jax_run, port_trainer):
    """``val/psnr`` of the same params within 1e-3 dB (measured: 9.5e-7 dB at 11.27 dB),
    logged to metrics.jsonl."""
    want = jax_run["jtr"].validate(JaxDataset(jax_run["jcfg"], is_inference=True), step=ITERATION)
    got = port_trainer.validate(TorchDataset(jax_run["tcfg"], is_inference=True), step=ITERATION)
    assert abs(got - want) <= 1e-3, (got, want)
    logged = open(os.path.join(port_trainer.logdir, "metrics.jsonl")).read().splitlines()[-1]
    assert f'"step": {ITERATION}' in logged and '"val/psnr"' in logged


def test_test_save_file_names_match_jax(jax_run, port_trainer, tmp_path):
    jtr = jax_run["jtr"]
    jax_inference.test_save(jtr, JaxDataset(jax_run["jcfg"], is_inference=True), str(tmp_path / "jax"))
    torch_inference.test_save(port_trainer, TorchDataset(jax_run["tcfg"], is_inference=True),
                              str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "0_rgb_map.png" in names and "0_normal_map.png" in names and "0_depth_map.png" in names
