"""The port's stage-a training (mlinerf_tpu_torch/trainers) against the JAX
package's: the per-iteration schedule, the learning rate and curvature
weight, and two train steps from injected batches (loss, updated params and
optimizer moments) at the production table dtype, bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close_to_leaf_max, bf16_ulp, configs, injected_batch

from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

ITERS = (0, 1, 150, 199, 200, 201, 400, 599, 600, 1201, 1601, 2000)


def _jax_step(jtr, params, opt_state, it, batch):
    """The JAX package's single-device train step (trainers/base.py
    ``_train_step_fn``), run eagerly."""
    cond = dict(jtr.make_cond(jnp.asarray(it, jnp.int32)))
    cond["max_levels"] = jtr.static_max_levels_for(it)
    weights = jtr.loss_weights_at(jnp.asarray(it, jnp.int32), cond)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jtr.model.apply({"params": p}, batch, cond, key, train=True)
        loss_dict, _ = jtr.compute_loss(out, batch, mode="train")
        total = jnp.zeros((), jnp.float32)
        for k, v in loss_dict.items():
            if k in weights:
                total = total + weights[k] * v
        return total

    total, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = jtr.tx.update(grads, opt_state, params)
    params = jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, updates)
    return params, opt_state, float(total)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    jcfg, tcfg = configs()
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax")))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("torch")), device="cpu")
    return jtr, ttr


@pytest.fixture(scope="module")
def two_steps(trainers):
    """Two train steps on each side from the same params and batches. The
    first update runs at lr(0) = 0 (warm-up) and only fills the moments; the
    second moves the params."""
    jtr, ttr = trainers
    rng = np.random.default_rng(0)
    arrays = TorchDataset(ttr.cfg).as_arrays()
    # Let the encoder reach the loss: geometric init zeroes the SDF MLP's
    # encoding columns, which would zero every table gradient.
    params = jax.tree.map(np.asarray, jtr.state.params)
    kernel = np.array(params["neural_sdf"]["mlp"]["linear_0"]["kernel"])
    kernel[3:] = rng.normal(0, 0.3, kernel[3:].shape)
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"] = kernel
    ttr.model.load_state_dict(params_from_jax(params))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = jtr.tx.init(jparams)
    losses = []
    for it in range(2):
        batch = injected_batch(arrays, rng, ttr.cfg.model.render.rand_rays)
        jparams, opt_state, jl = _jax_step(jtr, jparams, opt_state, it, {k: jnp.asarray(v) for k, v in batch.items()})
        info = ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        losses.append((float(info["total"]), jl))
    adam = opt_state[0]
    to_np = lambda tree: {k: v.float().numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}
    return dict(losses=losses, jparams=params_from_jax(jax.tree.map(np.asarray, jparams)),
                jmu=to_np(adam.mu), jnu=params_from_jax(jax.tree.map(np.asarray, adam.nu)),
                names=[n for n, _ in ttr.model.named_parameters()], ttr=ttr, start=params_from_jax(params))


def test_make_cond_matches(trainers):
    jtr, ttr = trainers
    for it in ITERS:
        jc, tc = jtr.make_cond(jnp.asarray(it, jnp.int32)), ttr.make_cond(it)
        assert np.float32(jc["progress"]) == tc["progress"], it
        assert np.float32(jc["normal_eps"]) == tc["normal_eps"], it
        np.testing.assert_array_equal(np.asarray(jc["level_mask"]), tc["level_mask"])
        assert int(jc["active_levels"]) == tc["active_levels"] and int(jc["anneal_levels"]) == tc["anneal_levels"]
        assert jtr.static_max_levels_for(it) == ttr.static_max_levels_for(it)


def test_lr_and_curvature_weight_match(trainers):
    jtr, ttr = trainers
    for it in ITERS:
        assert np.float32(jtr.lr_fn(it)) == ttr.lr_fn(it), it
        jw = jtr.loss_weights_at(jnp.asarray(it, jnp.int32), jtr.make_cond(jnp.asarray(it, jnp.int32)))
        tw = ttr.loss_weights_at(it, ttr.make_cond(it))
        assert sorted(jw) == sorted(tw)
        for k in jw:  # float32 pow may differ by an ulp
            np.testing.assert_allclose(tw[k], float(jw[k]), rtol=1e-6, err_msg=f"{k} at {it}")


def test_losses_match(two_steps):
    for got, want in two_steps["losses"]:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_updated_params_match(two_steps):
    """float32 params within 1e-6. bf16 tables: the JAX package's CPU path
    accumulates each row's table gradient in bf16 (the port in f32, then
    rounds), so their gradients differ by a few bf16 roundings; Adam turns
    that into a difference of a few percent of the step where a row's
    gradient is small, and of up to a whole step where bf16 cancels it to
    zero. So: 99% of entries within one bf16 ulp, every entry within one
    ulp plus 4 x the learning rate (the largest step Adam takes here)."""
    ttr, want = two_steps["ttr"], two_steps["jparams"]
    lr = float(ttr.lr_fn(1))
    moved = 0
    for name, p in ttr.model.state_dict().items():
        w = want[name]
        assert p.dtype == w.dtype, name
        if p.dtype == torch.bfloat16:
            diff = (p.float() - w.float()).abs()
            ulp = bf16_ulp(p, w)
            assert float((diff <= ulp).float().mean()) >= 0.99, name
            assert torch.all(diff <= ulp + 4 * lr), name
        else:
            np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)
        moved += int((p != two_steps["start"][name]).sum())
    assert moved > 0


def test_optimizer_moments_match(two_steps):
    """mu is float32; nu is kept in the param dtype (bf16 for the tables).
    float32 leaves within 1e-3 of the leaf max. The table moments inherit
    the JAX path's bf16-accumulated table gradients (see above): within
    25% of the leaf max there; test_adamw_matches_optax_with_bf16_leaf
    checks the bf16 arithmetic itself on equal gradients."""
    ttr = two_steps["ttr"]
    for name, mu, nu in zip(two_steps["names"], ttr.optimizer.mu, ttr.optimizer.nu):
        assert mu.dtype == torch.float32
        assert nu.dtype == two_steps["jnu"][name].dtype, name
        tol = 0.25 if nu.dtype == torch.bfloat16 else 1e-3
        assert_close_to_leaf_max(mu.numpy(), two_steps["jmu"][name], tol, name)
        assert_close_to_leaf_max(nu.float().numpy(), two_steps["jnu"][name].float().numpy(), tol, name)
    assert any(nu.dtype == torch.bfloat16 and nu.any() for nu in ttr.optimizer.nu)
