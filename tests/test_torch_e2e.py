"""The JAX package's shipped fast-path semantics in the port, against the
JAX package at the TINY size: train steps of configs/syn_e2e_a.yaml (the
auto stencil, blocked dense levels, sampling levels; bf16 tables, bridged
weights, midpoint samples, injected batches). The corner-sampled step is in
test_torch_corner_sample.py, the exact-hessian pass in
test_torch_stencil.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_ulp, configs, injected_batch, perturb_jax_params

from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.ops import hashgrid
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

E2E = "configs/syn_e2e_a.yaml"
# Two dense levels (9^3 and 17^3 rows within 2^13), 3 live levels of 4 at
# the start of coarse-to-fine (auto: 2 shared) and sampling on 2 of them.
E2E_TINY = ["--model.object.sdf.encoding.hashgrid.dict_size=13",
            "--model.object.sdf.encoding.coarse2fine.init_active_level=3", "--model.render.sampling_levels=2"]


def _jax_step(jtr, params, opt_state, it, batch):
    """The JAX package's single-device train step (trainers/base.py
    ``_train_step_fn``, a window of one), jitted with its static cap."""
    cond = dict(jtr.make_cond(jnp.asarray(it, jnp.int32)))
    cond["max_levels"] = jtr.static_max_levels_for(it)
    weights = jtr.loss_weights_at(jnp.asarray(it, jnp.int32), cond)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jtr.model.apply({"params": p}, batch, cond, key, train=True)
        loss_dict, _ = jtr.compute_loss(out, batch, mode="train")
        return sum(weights[k] * v for k, v in loss_dict.items() if k in weights), loss_dict

    @jax.jit
    def step(params, opt_state):
        (total, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        return jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, updates), opt_state, total, losses

    return step(params, opt_state)


@pytest.fixture(scope="module")
def e2e_step(tmp_path_factory):
    """Two steps on each side from the same params and batches, as
    tests/test_torch_train_step.py: the first at lr(0) = 0 (warm-up) fills
    the moments, the second moves the params."""
    jcfg, tcfg = configs(*E2E_TINY, config=E2E)
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax")))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("torch")), device="cpu")
    rng = np.random.default_rng(0)
    params = perturb_jax_params(jtr.state.params, rng)
    ttr.model.load_state_dict(params_from_jax(params))
    arrays = TorchDataset(tcfg).as_arrays()
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = jtr.tx.init(jparams)
    steps = []
    for it in range(2):
        batch = injected_batch(arrays, rng, tcfg.model.render.rand_rays)
        jparams, opt_state, jtotal, jlosses = _jax_step(jtr, jparams, opt_state, it,
                                                         {k: jnp.asarray(v) for k, v in batch.items()})
        hashgrid.gathers = 0
        info = ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        steps.append(dict(jtotal=float(jtotal), jlosses={k: float(v) for k, v in jlosses.items()}, info=info,
                          gathers=hashgrid.gathers))
    return dict(steps=steps, ttr=ttr, start=params_from_jax(params),
                jparams=params_from_jax(jax.tree.map(np.asarray, jparams)))


def test_e2e_config_runs_the_fast_path(e2e_step):
    """The shapes of the step: cap 3, so 2 shared levels; the stencil gathers
    each of the 3 live levels once (the finest one's 5 evaluations in one
    gather) and the one sampling evaluation 2 levels."""
    ttr = e2e_step["ttr"]
    cond = dict(ttr.make_cond(0), max_levels=ttr.static_max_levels_for(0))
    assert cond["max_levels"] == 3 and ttr.model.shared_levels(cond) == 2
    assert ttr.model.neural_sdf.dense_blocked
    assert all(step["gathers"] == 3 + 2 for step in e2e_step["steps"])


def test_e2e_losses_match(e2e_step):
    """Each loss within 1e-5 relative, the curvature within 1e-4: it is a
    second difference over eps^2 (about 1/80 here) of bf16 features, and a
    feature whose float32 sum of 8 corners rounds to the neighbouring bf16
    value in the other package's order moves it by that much."""
    for step in e2e_step["steps"]:
        info = step["info"]
        np.testing.assert_allclose(float(info["total"]), step["jtotal"], rtol=1e-5)
        assert sorted(info["losses"]) == sorted(step["jlosses"])
        for k, v in info["losses"].items():
            np.testing.assert_allclose(float(v), step["jlosses"][k], rtol=1e-4 if k == "curvature" else 1e-5,
                                       err_msg=k)


def test_e2e_updated_params_match(e2e_step):
    """As tests/test_torch_train_step.py: float32 leaves within 1e-6; bf16
    leaves (the tables: JAX sums their gradients in bf16, the port in f32)
    99% within one bf16 ulp and all within one ulp plus 4 x the learning
    rate (the largest step Adam takes here)."""
    ttr, want = e2e_step["ttr"], e2e_step["jparams"]
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
        moved += int((p != e2e_step["start"][name]).sum())
    assert moved > 0
