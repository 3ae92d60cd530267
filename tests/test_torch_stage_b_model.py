"""The port's stage-b model against the JAX package's at the TINY size: the
radiance head bank (``LumenRGB``) in every network mode and the render's
per-mode compositing on bridged params, the warm start from a JAX stage-a
checkpoint (``nonstrict_restore``'s report), and validation's component
PSNRs on a warm-started stage-b model."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, injected_batch, jax_stage_a_checkpoint, perturb_jax_params, port_name

from mlinerf_tpu.config import StaticConfig
from mlinerf_tpu.data.synthetic import Dataset as JaxDataset
from mlinerf_tpu.models.fields import LumenRGB as JaxLumenRGB
from mlinerf_tpu.models.lumen import Model as JaxModel
from mlinerf_tpu.models.mlp import MLPwithSkipConnection as JaxMLP
from mlinerf_tpu.models.neuralangelo import make_cond as jax_make_cond
from mlinerf_tpu.trainers.checkpoint import Checkpointer as JaxCheckpointer
from mlinerf_tpu.trainers.checkpoint import nonstrict_restore as jax_nonstrict_restore
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu.utils import encoding as jax_encoding
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.models.fields import LumenRGB
from mlinerf_tpu_torch.models.lumen import Model as TorchModel
from mlinerf_tpu_torch.models.neuralangelo import make_cond as torch_make_cond
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

SMALL = ["--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]", "--model.render.rand_rays_val=128"]
F32 = "--model.object.sdf.encoding.hashgrid.dtype=float32"
INTRINSIC = ("o_r", "o_s", "o_re")


def stage_configs(stage, *extra):
    return configs(*SMALL, *extra, config=f"configs/syn_sphere_{stage}.yaml")


def mode_configs(network_mode, *extra, input_mode="idr", shading_dim=3):
    """The stage-b configs with another network mode (``rgb`` is the plain
    head), input mode and shading width."""
    return stage_configs("b", f"--model.object.rgb.network_mode={network_mode}",
                         f"--model.object.rgb.mode={input_mode}", f"--model.object.rgb.shading_dim={shading_dim}",
                         *extra)


# ---------------------------------------------------------------------------
# The head bank and the render, per network mode
# ---------------------------------------------------------------------------


def _head_inputs(feat_dim):
    """Points, unit normals, unit view rays, features and light positions [1,50,C]."""
    rng = np.random.default_rng(0)
    p, n, v = (rng.normal(size=(1, 50, 3)) for _ in range(3))
    inputs = [p, n / np.linalg.norm(n, axis=-1, keepdims=True), v / np.linalg.norm(v, axis=-1, keepdims=True),
              rng.normal(size=(1, 50, feat_dim)), rng.uniform(-2, 2, (1, 50, 3))]
    return [x.astype(np.float32) for x in inputs]


@pytest.mark.parametrize("network_mode", ["rgb", "r_s", "r_s_re", "rgb_r", "rgb_r_s"])
def test_lumen_rgb_heads_match_jax(network_mode):
    """Every head's output within 1e-6 (measured: 4.8e-7) on random inputs,
    from JAX-initialized params; the heads carry the JAX names."""
    jcfg, tcfg = mode_configs(network_mode)
    feat_dim = tcfg.model.object.sdf.mlp.hidden_dim
    inputs = _head_inputs(feat_dim)
    jhead = JaxLumenRGB(StaticConfig(jcfg.model).object.rgb, feat_dim=feat_dim,
                        appear_embed=StaticConfig(jcfg.model).appear_embed)
    params = jhead.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs))["params"]
    want = jhead.apply({"params": params}, *map(jnp.asarray, inputs))
    head = LumenRGB(tcfg.model.object.rgb, feat_dim=feat_dim, generator=torch.Generator().manual_seed(0))
    head.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    got = head(*map(torch.from_numpy, inputs))
    # The JAX bank returns a tuple in this order; the port names its outputs.
    names = {"rgb": ["rgb"], "r_s": ["o_r", "o_s"], "r_s_re": ["o_r", "o_s", "o_re"], "rgb_r": ["rgb", "o_r"],
             "rgb_r_s": ["rgb", "o_r", "o_s"]}[network_mode]
    want = want if isinstance(want, tuple) else (want,)
    assert sorted(got) == sorted(names) and len(want) == len(names)
    for name, w in zip(names, want):
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    assert {n.split(".")[0] for n, _ in head.named_parameters()} == set(params)


@pytest.mark.parametrize("input_mode,kept", [("no_view_dir", "pnfl"), ("no_normal", "pvfl")])
def test_plain_head_input_variants(input_mode, kept):
    """The plain head without the view direction or the normal: the JAX
    package's ``LumenRGB`` raises in these modes (``list.remove`` compares
    arrays), so the port is held to its intended function instead: the JAX
    MLP with the same params on [p, n, f, l] or [p, v, f, l], within 1e-6
    (measured: 1.5e-7)."""
    jcfg, tcfg = mode_configs("rgb", input_mode=input_mode)
    feat_dim = tcfg.model.object.sdf.mlp.hidden_dim
    inputs = _head_inputs(feat_dim)
    p, n, v, f, light = inputs
    levels = tcfg.model.object.rgb.encoding_view.levels
    parts = dict(p=p, v=jax_encoding.spherical_harmonics(jnp.asarray(v), levels), n=n, f=f,
                 l=jax_encoding.spherical_harmonics(jnp.asarray(light), levels))
    x = jnp.concatenate([jnp.asarray(parts[k]) for k in kept], -1)
    cfg_mlp = tcfg.model.object.rgb.mlp
    jmlp = JaxMLP(layer_dims=tuple([x.shape[-1]] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers + [3]),
                  skip_connection=tuple(cfg_mlp.skip), activ=jax.nn.relu, use_weightnorm=cfg_mlp.weight_norm)
    params = jmlp.init(jax.random.PRNGKey(1), x)["params"]
    want = np.asarray(jax.nn.sigmoid(jmlp.apply({"params": params}, x)))
    head = LumenRGB(tcfg.model.object.rgb, feat_dim=feat_dim, generator=torch.Generator().manual_seed(0))
    head.load_state_dict(params_from_jax({"mlp": jax.tree.map(np.asarray, params)}))
    got = head(*map(torch.from_numpy, inputs))["rgb"].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("network_mode,shading_dim", [("r_s", 3), ("r_s_re", 3), ("rgb_r", 3), ("rgb_r_s", 1)])
def test_render_rays_intrinsic_modes_match_jax(network_mode, shading_dim):
    """The composited rgb and o_r / o_s / o_re of a training render (white
    background) within 1e-5 (measured: 4.2e-7), from the same perturbed,
    bridged params and rays."""
    jcfg, tcfg = mode_configs(network_mode, F32, shading_dim=shading_dim)
    rng = np.random.default_rng(0)
    batch = injected_batch(TorchDataset(stage_configs("a")[1]).as_arrays(), rng, tcfg.model.render.rand_rays)
    jmodel = JaxModel(StaticConfig(jcfg.model), StaticConfig(jcfg.data))
    jcond = jax_make_cond(jcfg.model, jnp.asarray(10, jnp.int32), jcfg.max_iter, jcfg.optim.sched.warm_up_end)
    key = jax.random.PRNGKey(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = perturb_jax_params(jmodel.init(key, jbatch, jcond, key, train=True)["params"], rng)
    want = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)}, jbatch, jcond, key, train=True)
    tmodel = TorchModel(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(params_from_jax(params))
    got = tmodel({k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                 torch_make_cond(tcfg.model, 10, tcfg.max_iter, tcfg.optim.sched.warm_up_end), train=True)
    keys = ["rgb"] + [k for k in INTRINSIC if k in want]
    assert keys == ["rgb"] + [k for k in INTRINSIC if k in got]
    assert "o_s" in keys and (("o_re" in keys) == (network_mode in ("r_s_re", "rgb_r_s")))
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    assert got["o_s"].shape[-1] == shading_dim


# ---------------------------------------------------------------------------
# Warm start and validation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_a_checkpoint(tmp_path_factory):
    return jax_stage_a_checkpoint(stage_configs("a")[0], str(tmp_path_factory.mktemp("stage_a")))


@pytest.fixture(scope="module")
def stage_b(stage_a_checkpoint, tmp_path_factory):
    """Both packages' stage-b trainers warm-started from that checkpoint;
    the port then takes the JAX trainer's params, so both start equal."""
    jcfg, tcfg = stage_configs("b", f"--model.use_pre_trained.pt_filename={stage_a_checkpoint}")
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax_b")))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("port_b")), device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    return dict(jtr=jtr, ttr=ttr, jcfg=jcfg, tcfg=tcfg)


@pytest.mark.parametrize("extra", [[], ["--model.object.rgb.mlp.hidden_dim=32"]], ids=["same_widths", "narrower_heads"])
def test_warm_start_report_matches_jax(stage_a_checkpoint, tmp_path, extra):
    """The port's warm start from the JAX checkpoint reports the names the
    JAX package's ``nonstrict_restore`` reports (mapped to the port's
    names): the heads stage a lacks are missing; with narrower heads the
    shared ``mlp`` leaves are mismatched. Every carried leaf is copied."""
    jcfg, tcfg = stage_configs("b", f"--model.use_pre_trained.pt_filename={stage_a_checkpoint}", *extra)
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path / "jax"))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / "port"), device="cpu")
    source = JaxCheckpointer.load_file(stage_a_checkpoint)["state"]["params"]
    _, want = jax_nonstrict_restore(jax.tree.map(np.asarray, jtr.state.params), source)
    got = ttr.warm_start_report
    for key in ("missing", "unexpected", "mismatched"):
        assert sorted(got[key]) == sorted(port_name(p) for p in want[key]), key
    assert any(".mlp_r." in n for n in got["missing"]) and any(".mlp_s." in n for n in got["missing"])
    assert not got["unexpected"]
    assert bool(got["mismatched"]) == bool(extra)
    carried = params_from_jax(source)
    state = ttr.model.state_dict()
    skipped = set(got["mismatched"])
    for name, value in carried.items():
        if name not in skipped:
            assert torch.equal(state[name], value.to(state[name].dtype)), name
    assert ("neural_rgb.mlp.linear_0.weight" in skipped) == bool(extra)




def test_validate_component_psnr_matches_jax(stage_b):
    """``val/psnr``, ``val/psnr_ref`` and ``val/psnr_sha`` of the stage-b
    model (rgb_r_s, shading_dim 1) within 1e-3 dB (measured: 2.9e-6 dB)."""
    jtr, ttr = stage_b["jtr"], stage_b["ttr"]
    jtr.validate(JaxDataset(stage_b["jcfg"], is_inference=True), step=5, max_samples=2)
    ttr.validate(TorchDataset(stage_b["tcfg"], is_inference=True), step=5, max_samples=2)

    def last_line(trainer):
        return json.loads(open(os.path.join(trainer.logdir, "metrics.jsonl")).read().splitlines()[-1])

    want, got = last_line(jtr), last_line(ttr)
    for key in ("val/psnr", "val/psnr_ref", "val/psnr_sha"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)
