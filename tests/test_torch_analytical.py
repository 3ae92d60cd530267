"""Analytical SDF gradients (``gradient.mode: analytical``) in the port
against the JAX package at the TINY size: the autograd gradient and the
Hessian diagonal on the Fourier and the hash-grid SDF (and the Fourier
encoding itself), one training step's
loss and parameter gradients, and the step's backward reaching the table
gradient (``TakeRows.backward``, the scatter) once per hash level; then the
mode through the port's CLIs on the CPU.

Tolerances: the gradient within 1e-5; the Hessian within 1e-4 of its
largest entry; each parameter's gradient within 1e-4 of its leaf's
largest entry."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, assert_close_to_leaf_max, configs, model_pair, perturb_jax_params, stage_a_loss

from mlinerf_tpu.config import StaticConfig
from mlinerf_tpu.models import fields as jax_fields
from mlinerf_tpu.models.lumen import Model as JaxModel
from mlinerf_tpu.models.neuralangelo import make_cond as jax_make_cond
from mlinerf_tpu_torch import test as test_cli
from mlinerf_tpu_torch import train as train_cli
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.models import fields
from mlinerf_tpu_torch.models.lumen import Model as TorchModel
from mlinerf_tpu_torch.models.neuralangelo import make_cond as torch_make_cond
from mlinerf_tpu_torch.ops import hashgrid_scatter
from mlinerf_tpu_torch.utils import losses as torch_losses
from mlinerf_tpu_torch.utils.image_io import read_png

ANALYTICAL = ["--model.object.sdf.gradient.mode=analytical", "--model.object.sdf.encoding.hashgrid.dtype=float32"]
FOURIER = ["--model.object.sdf.encoding.type=fourier", "--model.object.sdf.encoding.levels=3"]
ITER = 10
LEVELS = 4


@pytest.mark.parametrize("encoding", ["fourier", "hashgrid"])
def test_gradient_and_hessian_match_jax(encoding):
    """``compute_gradients`` (its own field evaluation, as in JAX) on
    points inside and around the unit sphere: the gradient within 1e-5,
    the Hessian diagonal within 1e-4 of its largest entry; in evaluation
    the gradient alone, without a graph."""
    jcfg, tcfg = configs(*ANALYTICAL, *(FOURIER if encoding == "fourier" else []))
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(1, 64, 3)) * 0.5).astype(np.float32)
    jmodel = JaxModel(StaticConfig(jcfg.model), StaticConfig(jcfg.data))
    warm = jcfg.optim.sched.warm_up_end
    jcond = jax_make_cond(jcfg.model, jnp.asarray(ITER, jnp.int32), jcfg.max_iter, warm)
    tcond = torch_make_cond(tcfg.model, ITER, tcfg.max_iter, warm)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pts), jcond,
                         method=lambda m, p, c: m.sdf_only(p, c))["params"]
    if encoding == "hashgrid":
        params = perturb_jax_params(params, rng)
    else:
        params = jax.tree.map(np.asarray, params)
    want_g, want_h = jax.jit(lambda prm, p: jmodel.apply({"params": prm}, p, jcond, True,
                                                         method=lambda m, q, c, t: m.compute_gradients(q, c, t)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    model = TorchModel(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))
    # The SDF's params only (its feature layer is not built by an SDF-only
    # init, and the SDF does not read it).
    assert not model.load_state_dict(params_from_jax(params), strict=False).unexpected_keys
    g, h = model.compute_gradients(torch.from_numpy(pts), tcond, training=True)
    assert g.shape == h.shape == (1, 64, 3) and g.requires_grad and h.requires_grad
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g), rtol=0, atol=1e-5)
    assert_close_to_leaf_max(h.detach().numpy(), np.asarray(want_h), 1e-4, "hessian")
    with torch.no_grad():
        g_eval, h_eval = model.compute_gradients(torch.from_numpy(pts), tcond, training=False)
    assert h_eval is None and not g_eval.requires_grad
    np.testing.assert_array_equal(g_eval.numpy(), g.detach().numpy())


@pytest.mark.parametrize("mask", [None, [1.0, 1.0, 0.0]])
def test_fourier_encoding_matches_jax(mask):
    """The Fourier SDF's input: the points and their positional encoding
    (6 x 3 levels), a level mask repeated 6 times per entry as the JAX
    package applies it; within 1e-6 (XLA's and torch's float32 sin and cos
    differ by an ulp on some inputs), the masked entries exactly 0."""
    jcfg, tcfg = configs(*FOURIER)
    pts = (np.random.default_rng(1).normal(size=(2, 5, 3)) * 0.5).astype(np.float32)
    jsdf = jax_fields.NeuralSDF(StaticConfig(jcfg.model.object.sdf))
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    want = jsdf.apply({"params": {}}, jnp.asarray(pts), jmask, method=lambda m, p, lm: m.encode(p, level_mask=lm))
    sdf = fields.NeuralSDF(tcfg.model.object.sdf, torch.Generator().manual_seed(0))
    got = sdf.encode(torch.from_numpy(pts), level_mask=None if mask is None else np.asarray(mask, np.float32))
    assert got.shape == (2, 5, 3 + 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


@pytest.fixture(scope="module")
def parity():
    return model_pair(*configs(*ANALYTICAL), iteration=ITER, max_levels=LEVELS)


@pytest.mark.parametrize("key", ["rgb", "weights", "gradients"])
def test_step_outputs_match(parity, key):
    np.testing.assert_allclose(parity["tout"][key], parity["jout"][key], rtol=0, atol=1e-5)


def test_step_hessians_match(parity):
    """On rays inside the bounding sphere (outside rays are masked out of
    the loss), within 1e-4 of the largest entry."""
    inside = ~parity["jout"]["outside"][..., 0]
    assert inside.any()
    assert_close_to_leaf_max(parity["tout"]["hessians"][inside], parity["jout"]["hessians"][inside], 1e-4,
                             "hessians")


def test_step_loss_and_param_grads_match(parity):
    """The stage-a loss (L1 x 3, eikonal, curvature) within 1e-6 relative
    and every parameter's gradient within 1e-4 of its leaf's largest
    entry: the tables' gradient is the cotangent of all three terms through
    the field, its gradient and its Hessian."""
    np.testing.assert_allclose(parity["tl"], parity["jl"], rtol=1e-6)
    for name, p in parity["tmodel"].named_parameters():
        assert_close_to_leaf_max(p.grad.numpy(), parity["jgrads"][name], 1e-4, name)
    assert all(parity["tmodel"].neural_sdf.hash_table[lv].grad.abs().max() > 0 for lv in range(LEVELS))


def test_backward_scatters_once_per_level(parity, monkeypatch):
    """The step's backward reaches each level's ``TakeRows.backward`` once,
    with the summed cotangent of every order: one scatter per level (the
    numerical path's taps add a second), giving the same table gradient."""
    tmodel, batch = parity["tmodel"], parity["batch"]
    calls = []
    original = hashgrid_scatter.scatter_add_rows

    def counting(idx, vals, table_size):
        calls.append(table_size)
        return original(idx, vals, table_size)

    monkeypatch.setattr(hashgrid_scatter, "scatter_add_rows", counting)
    tcfg = configs(*ANALYTICAL)[1]
    cond = torch_make_cond(tcfg.model, ITER, tcfg.max_iter, tcfg.optim.sched.warm_up_end)
    cond["max_levels"] = LEVELS
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tables = list(tmodel.neural_sdf.hash_table)
    out = tmodel(tbatch, cond, train=True)
    assert calls == []
    grads = torch.autograd.grad(stage_a_loss(torch_losses, out, tbatch["image_sampled"]), tables)
    assert calls == [t.shape[0] for t in tables][::-1]
    for lv, g in enumerate(grads):
        np.testing.assert_array_equal(g.numpy(), tables[lv].grad.numpy())


def test_analytical_train_and_render_cli(tmp_path):
    """``python -m mlinerf_tpu_torch.train`` with
    ``--model.object.sdf.gradient.mode=analytical`` trains the Lumen model,
    and ``test --inference_mode image_test`` renders it (gradients without
    a graph)."""
    logdir = str(tmp_path / "analytical")
    args = ["--config", "configs/syn_sphere_a.yaml", "--logdir", logdir, "--device", "cpu",
            *[a for a in TINY if "image_size" not in a], "--model.object.sdf.gradient.mode=analytical",
            "--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]"]
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main(args + ["--max_iter=2", "--logging_iter=1"])
        test_cli.main(args + ["--inference_mode", "image_test", "--data.val.subset=1"])
    assert trainer.model._analytical()
    normal = read_png(f"{logdir}/output_image/0_normal_map.png")
    assert normal.shape == (16, 16, 3) and normal.std() > 0
