"""The port's Instant-NGP (mlinerf_tpu_torch/models/ingp.py) and the NeRF
trainer's optimizer against the JAX package on the CPU: one training
forward and backward of the model at TINY size (L4 F4, dict 12, float32
tables; float32 and bf16 MLPs), its parameters carried from a JAX
checkpoint, one Adam step of the trainer from an injected batch, and the
learning-rate schedule of the shipped configs.

The JAX side's table gradient runs as its own tests run it on the CPU
(``take_rows`` with XLA's scatter, ``hashgrid_pallas.py:162-167``), the
port's through ``scatter_add_rows``' plain version. Tolerances as in
tests/test_torch_nerf.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close_to_leaf_max, assert_nerf_pair_close, nerf_batch, nerf_configs, nerf_pair

from mlinerf_tpu.trainers.nerf import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.ops import hashgrid_scatter
from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer
from mlinerf_tpu_torch.trainers.nerf import Trainer as TorchTrainer

INGP = "configs/ingp_blender.yaml"
BLENDER = "configs/nerf_blender.yaml"


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16"])
def test_ingp_model_matches_jax(amp):
    pair = nerf_pair(INGP, amp=amp)
    if amp:
        assert_nerf_pair_close(pair, loss_rtol=1e-4, out_atol=1e-3, grad_rtol=2e-2, bias_grad_rtol=0.25)
    else:
        assert_nerf_pair_close(pair, loss_rtol=1e-5, out_atol=1e-5, grad_rtol=1e-4)
    tables = [p for n, p in pair["tmodel"].named_parameters() if ".hash_table." in n]
    # float32 tables whatever hashgrid.dtype says; the 3D input is points ‖ L*F features.
    assert [t.dtype for t in tables] == [torch.float32] * 4
    assert pair["tcfg"].model.posenc.hashgrid.dtype == "bfloat16"
    assert pair["tmodel"].nerf.mlp_feat.linear_0.weight.shape[1] == 3 + 4 * 4
    assert all(float(t.grad.abs().max()) > 0 for t in tables)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX package's and the port's NeRF trainers on the TINY INGP
    config, the port's loaded from the JAX trainer's checkpoint."""
    jcfg, tcfg = nerf_configs(INGP, "--model.rand_rays=64", "--trainer.amp_config.enabled!")
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax")))
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, jtr.state.params)
    params["nerf"]["hash_table"] = tuple(rng.uniform(-0.1, 0.1, t.shape).astype(t.dtype)
                                         for t in params["nerf"]["hash_table"])
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    jtr.save_checkpoint(iteration=0)
    jtr.checkpointer.wait()
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("torch")), device="cpu")
    ttr.load_checkpoint(f"{jtr.logdir}/latest_checkpoint.txt")
    return jtr, ttr, params


def test_jax_checkpoint_loads_into_the_port(trainers):
    """The bridge names every leaf of the JAX tree as the port's state dict
    (``nerf.hash_table.<level>``, ``nerf.mlp_feat.linear_0.weight``, ...)
    and carries the values exactly."""
    jtr, ttr, params = trainers
    payload = Checkpointer.load_file(f"{jtr.logdir}/latest_checkpoint.txt")
    state = ttr.model.state_dict()
    assert sorted(payload["state"]["params"]) == sorted(state)
    assert [f"nerf.hash_table.{lv}" in state for lv in range(4)] == [True] * 4
    for name, value in params_from_jax(params).items():
        assert torch.equal(state[name], value), name


def test_one_adam_step_matches_optax(trainers):
    """One train step from an injected batch: optax.adam (the JAX trainer's
    ``tx``) and the port's Adam. The loss within 1e-6; the first moments
    within 1e-4 of the leaf max (they are 0.1 x the gradient); the updated
    parameters within 1e-6 + lr * 1e-3 where the JAX gradient is at least
    100 eps = 1e-6 (Adam's first step is lr * g / (|g| + eps), flat there),
    and within 2 lr + 1e-6 elsewhere."""
    jtr, ttr, params = trainers
    batch = nerf_batch(ttr.cfg, np.random.default_rng(6))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    cond = jtr.make_cond(jnp.asarray(0, jnp.int32))

    def loss_fn(p):
        out = jtr.model.apply({"params": p}, jbatch, cond, key, train=True)
        return jtr.compute_loss(out, jbatch, mode="train")[0]["render"]

    jparams = jax.tree.map(jnp.asarray, params)
    jl, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    opt_state = jtr.tx.init(jparams)
    updates, opt_state = jtr.tx.update(jgrads, opt_state, jparams)
    jnew = params_from_jax(jax.tree.map(lambda p, u: np.asarray(p + u), jparams, updates))
    jmu = params_from_jax(jax.tree.map(np.asarray, opt_state[0].mu))
    jg = params_from_jax(jax.tree.map(np.asarray, jgrads))
    before = hashgrid_scatter.launches
    info = ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert hashgrid_scatter.launches == before  # the plain version on the CPU
    np.testing.assert_allclose(float(info["total"]), float(jl), rtol=1e-6)
    lr = float(ttr.lr_fn(0))
    assert lr == np.float32(0.01) and ttr.optimizer.weight_decay == 0.0
    for i, (name, p) in enumerate(ttr.model.named_parameters()):
        assert_close_to_leaf_max(ttr.optimizer.mu[i].numpy(), jmu[name].numpy(), 1e-4, name)
        got, want, g = p.detach().numpy(), jnew[name].numpy(), np.abs(jg[name].numpy())
        flat = g >= 1e-6
        np.testing.assert_allclose(got[flat], want[flat], rtol=0, atol=1e-6 + lr * 1e-3, err_msg=name)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 + 2 * lr, err_msg=name)
        assert np.any(got != params_from_jax(params)[name].numpy()), name


@pytest.mark.parametrize("config", [BLENDER, INGP, "configs/nerf_synthetic_low.yaml"])
def test_lr_schedule_matches_jax(config):
    """The step schedule as the JAX package computes it: ``iteration_mode``
    is ignored and optax counts updates, so nerf_blender's LR decays by
    0.97724 every 20 iterations (the reference steps per epoch). Bitwise
    at every iteration checked."""
    from mlinerf_tpu.trainers.optim import make_optimizer as jax_make_optimizer
    from mlinerf_tpu_torch.trainers.optim import make_optimizer

    jcfg, tcfg = nerf_configs(config)
    _, jax_lr = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter)
    _, lr_fn = make_optimizer(tcfg.optim, [torch.zeros(1)])
    iters = [0, 1, 19, 20, 21, 39, 40, 999, 1000, 12345, 100000, 499999]
    got = np.asarray([lr_fn(it) for it in iters], np.float32)
    want = np.asarray([jax_lr(it) for it in iters], np.float32)
    np.testing.assert_array_equal(got, want)
    if config == BLENDER:
        assert got[2] == np.float32(5e-4) and got[3] == np.float32(5e-4) * np.float32(0.97724)

