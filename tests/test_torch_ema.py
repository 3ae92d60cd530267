"""The port's parameter average (``trainer.ema_config``;
mlinerf_tpu_torch/trainers/optim.ema_update and BaseTrainer) against the
JAX package's, on the CPU: the cases of tests/test_ema.py on the port (the
recursion, real copies, evaluation from the average, the checkpoint round
trip), the arithmetic in each leaf's dtype against JAX's ``ema_update``,
one injected-batch step against JAX's step, a JAX checkpoint with
``ema_params`` loaded by the port, and the order of the EMA copy and the
stage-b warm start (the JAX package averages from its random init, the port
from the checkpoint)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _jax_step
from torch_parity import bf16_ulp, configs, injected_batch, jax_stage_a_checkpoint, perturb_jax_params

from mlinerf_tpu.trainers import optim as jax_optim
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.pipelines import mesh_extract
from mlinerf_tpu_torch.trainers import optim
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

BETA = 0.9
STEP = ["--optim.sched.warm_up_end=0", "--model.render.rand_rays=32"]
EMA = ["--trainer.ema_config.enabled", f"--trainer.ema_config.beta={BETA}", *STEP]


def _port_trainer(tmp_path, tag, *extra, **kwargs):
    _, tcfg = configs(*EMA, *extra)
    return TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / tag), device="cpu", **kwargs)


def _host(model):
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()}


def _train_steps(tr, steps):
    arrays = {k: torch.as_tensor(v) for k, v in TorchDataset(tr.cfg).as_arrays().items()}
    for _ in range(steps):
        tr.train_step(tr.sample_batch(arrays))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("beta", [0.9, 0.999])
def test_ema_update_matches_jax_bitwise(dtype, beta):
    """avg * beta + new * (1 - beta) in the leaf's dtype, each product and
    the sum rounded to it, beta and 1 - beta rounded first (0.999 is 1.0
    in bfloat16)."""
    rng = np.random.default_rng(0)
    avg = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    new = avg + rng.normal(0, 0.05, avg.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_optim.ema_update([jnp.asarray(avg, jdt)], [jnp.asarray(new, jdt)], beta)[0]
    got = torch.from_numpy(avg).to(dtype)
    optim.ema_update([got], [torch.from_numpy(new).to(dtype)], beta)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_ema_is_decayed_average_of_params(tmp_path):
    """ema_{t+1} = beta * ema_t + (1 - beta) * params_{t+1}, replayed on the
    host in float32, within test_ema.py's bf16 tolerance."""
    tr = _port_trainer(tmp_path, "ema_par")
    expect = _host(tr.model)
    arrays = {k: torch.as_tensor(v) for k, v in TorchDataset(tr.cfg).as_arrays().items()}
    for _ in range(3):
        tr.train_step(tr.sample_batch(arrays))
        p = _host(tr.model)
        expect = {k: BETA * expect[k] + (1.0 - BETA) * p[k] for k in p}
    got = _host(tr.ema_model)
    for k in expect:
        np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(), rtol=2e-3, atol=2e-6, err_msg=k)
    # The average lags the trained parameters (no aliasing collapse).
    assert max(float((got[k] - p[k]).abs().max()) for k in p) > 0.0


def test_ema_initial_copy_not_aliased(tmp_path):
    tr = _port_trainer(tmp_path, "ema_alias")
    params, ema = list(tr.model.parameters()), list(tr.ema_model.parameters())
    assert len(params) == len(ema) > 0
    for p, e in zip(params, ema):
        assert torch.equal(p, e) and p.dtype == e.dtype
        assert p is not e and p.data_ptr() != e.data_ptr()
        assert not e.requires_grad


def test_ema_eval_model_and_e2e_train(tmp_path):
    """train() end to end with EMA on; every evaluation (render_image, the
    mesh probes) renders from the average."""
    tr = _port_trainer(tmp_path, "ema_e2e", "--max_iter=4", "--data.val.image_size=[16,16]")
    arrays = TorchDataset(tr.cfg).as_arrays()
    info = tr.train(arrays)
    assert np.isfinite(float(info["total"]))
    assert tr.eval_model() is tr.ema_model
    # A trainer without EMA holding the average as its model renders the
    # same image.
    _, cfg = configs(*STEP, "--max_iter=4", "--data.val.image_size=[16,16]")
    plain = TorchTrainer(cfg, is_inference=True, seed=0, logdir=str(tmp_path / "plain"), device="cpu")
    assert plain.ema_model is None and plain.eval_model() is plain.model
    plain.model.load_state_dict(tr.ema_model.state_dict())
    plain.current_iteration = tr.current_iteration
    sample = TorchDataset(tr.cfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
    got = tr.inference_outputs(data, (16, 16))
    want = plain.inference_outputs(data, (16, 16))
    np.testing.assert_array_equal(got["rgb_map"], want["rgb_map"])
    pts = torch.rand(64, 3) * 2 - 1
    with torch.no_grad():
        assert torch.equal(mesh_extract.trainer_sdf_fn(tr)(pts), mesh_extract.trainer_sdf_fn(plain)(pts))
        moved = tr.model.sdf_only(pts[None], tr.make_cond(4))[0, :, 0]
    assert not torch.equal(mesh_extract.trainer_sdf_fn(tr)(pts).detach(), moved)


def test_ema_checkpoint_roundtrip(tmp_path):
    tr = _port_trainer(tmp_path, "ema_ckpt", "--max_iter=2")
    _train_steps(tr, 2)
    tr.save_checkpoint(latest=True)
    tr2 = _port_trainer(tmp_path, "ema_ckpt", "--max_iter=2")
    assert tr2.load_checkpoint(resume=True)
    for (k, a), b in zip(tr.ema_model.state_dict().items(), tr2.ema_model.state_dict().values()):
        assert torch.equal(a, b), k
    assert not all(torch.equal(a, b) for a, b in zip(tr2.ema_model.parameters(), tr2.model.parameters()))


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ema_trainer(tmp_path_factory):
    jcfg, tcfg = configs(*EMA)
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax_ema")))
    assert jtr.ema_enabled
    return jtr, tcfg


def test_ema_step_matches_jax(jax_ema_trainer, tmp_path):
    """One step from an injected batch: the port's average against the
    JAX package's step and ema_update. float32 leaves within 1e-6; bf16
    tables within one bf16 ulp plus (1 - beta) x the bound of the updated
    tables themselves (one ulp + 4 x lr, tests/test_torch_train_step.py).
    On the port's own updated params, JAX's ema_update gives the port's
    average bit for bit."""
    jtr, tcfg = jax_ema_trainer
    rng = np.random.default_rng(0)
    params = perturb_jax_params(jtr.state.params, rng)
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / "port"), device="cpu")
    start = params_from_jax(params)
    ttr.model.load_state_dict(start)
    ttr.ema_model.load_state_dict(start)
    batch = injected_batch(TorchDataset(tcfg).as_arrays(), rng, tcfg.model.render.rand_rays)
    jparams = jax.tree.map(jnp.asarray, params)
    new_jparams, _, _ = _jax_step(jtr, jparams, jtr.tx.init(jparams), 0,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    jema = params_from_jax(jax.tree.map(np.asarray, jax_optim.ema_update(jparams, new_jparams, BETA)))
    ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    lr = float(ttr.lr_fn(0))
    assert lr > 0
    moved = 0
    for name, e in ttr.ema_model.state_dict().items():
        w = jema[name]
        assert e.dtype == w.dtype, name
        if e.dtype == torch.bfloat16:
            diff = (e.float() - w.float()).abs()
            assert torch.all(diff <= bf16_ulp(e, w) + (1 - BETA) * (bf16_ulp(e, w) + 4 * lr)), name
        else:
            np.testing.assert_allclose(e.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)
        moved += int((e != start[name]).sum())
    assert moved > 0
    # The arithmetic alone: JAX's ema_update on the port's own step.
    port_new = {k: v.detach() for k, v in ttr.model.state_dict().items()}
    for name, e in ttr.ema_model.state_dict().items():
        jdt = jnp.bfloat16 if e.dtype == torch.bfloat16 else jnp.float32
        want = jax_optim.ema_update(jnp.asarray(start[name].float().numpy(), jdt),
                                    jnp.asarray(port_new[name].float().numpy(), jdt), BETA)
        np.testing.assert_array_equal(e.float().numpy(), np.asarray(want, np.float32), err_msg=name)


def test_jax_checkpoint_with_ema_loads_into_port(jax_ema_trainer, tmp_path):
    jtr, tcfg = jax_ema_trainer
    rng = np.random.default_rng(1)
    params = perturb_jax_params(jtr.state.params, rng)
    ema = perturb_jax_params(jtr.state.params, rng)
    saved = jtr.state
    jtr.state = saved.replace(params=jax.tree.map(jnp.asarray, params), ema_params=jax.tree.map(jnp.asarray, ema))
    jtr.checkpointer.logdir = str(tmp_path)
    try:
        jtr.save_checkpoint(iteration=5)
        jtr.checkpointer.wait()
    finally:
        jtr.state = saved
    ttr = TorchTrainer(tcfg, is_inference=True, seed=0, logdir=str(tmp_path / "port"), device="cpu")
    assert ttr.load_checkpoint(str(tmp_path / "latest_checkpoint.txt"), resume=False, load_opt=False)
    assert ttr.current_iteration == 5
    for name, want in params_from_jax(ema).items():
        assert torch.equal(ttr.ema_model.state_dict()[name], want), name
    for name, want in params_from_jax(params).items():
        assert torch.equal(ttr.model.state_dict()[name], want), name
    assert ttr.eval_model() is ttr.ema_model


def test_ema_starts_after_the_warm_start(tmp_path):
    """Stage b with EMA on, warm-started from a JAX stage-a checkpoint: the
    JAX package's average is its random init (copied before the warm
    start), the port's is the warm-started model, checkpoint leaves
    included."""
    jcfg_a, _ = configs()
    pointer = jax_stage_a_checkpoint(jcfg_a, str(tmp_path / "a"))
    stage_b = ["--data.train.pseudo_label.enabled!", f"--model.use_pre_trained.pt_filename={pointer}", *EMA]
    jcfg, tcfg = configs(*stage_b, config="configs/syn_sphere_b.yaml")
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path / "jax_b"))
    jcfg_init, _ = configs(*stage_b[:1], *EMA, config="configs/syn_sphere_b.yaml")
    jcfg_init.model.pop("use_pre_trained")
    jinit = params_from_jax(jax.tree.map(np.asarray, JaxTrainer(jcfg_init, seed=0, logdir=str(tmp_path / "j0")).state.params))
    jparams = params_from_jax(jax.tree.map(np.asarray, jtr.state.params))
    jema = params_from_jax(jax.tree.map(np.asarray, jtr.state.ema_params))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / "port_b"), device="cpu")
    ema, model = ttr.ema_model.state_dict(), ttr.model.state_dict()
    sdf = [k for k in model if k.startswith("neural_sdf.")]
    assert sdf and not any(k in ttr.warm_start_report["missing"] for k in sdf)
    for k in sdf:
        # The JAX average: the init, not the checkpoint the params hold.
        np.testing.assert_array_equal(jema[k].float().numpy(), jinit[k].float().numpy(), err_msg=k)
        # The port's average: the warm-started params, equal to JAX's.
        assert torch.equal(ema[k], model[k]) and torch.equal(model[k], jparams[k]), k
    assert any(not torch.equal(jema[k], jparams[k]) for k in sdf)
