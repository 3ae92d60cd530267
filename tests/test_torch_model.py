"""The port's Lumen model (mlinerf_tpu_torch/models/lumen.py) against the JAX
package's at the TINY size: the same bridged params, the same rays, midpoint
samples. Covers the dataset, the render outputs, and the gradient of every
parameter for a stage-a loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close_to_leaf_max, configs, injected_batch, perturb_jax_params

from mlinerf_tpu.config import StaticConfig
from mlinerf_tpu.data.synthetic import Dataset as JaxDataset
from mlinerf_tpu.models.lumen import Model as JaxModel
from mlinerf_tpu.models.neuralangelo import make_cond as jax_make_cond
from mlinerf_tpu.utils import losses as jax_losses
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.models.lumen import Model as TorchModel
from mlinerf_tpu_torch.models.neuralangelo import make_cond as torch_make_cond
from mlinerf_tpu_torch.utils import losses as torch_losses

ITER = 10
MAX_LEVELS = 4


def _loss(losses, out, target):
    return (3 * losses.l1_loss(out["rgb"], target)
            + 0.1 * losses.eikonal_loss(out["gradients"], outside=out["outside"])
            + 5e-4 * losses.curvature_loss(out["hessians"], outside=out["outside"]))


@pytest.fixture(scope="module")
def parity():
    jcfg, tcfg = configs("--model.object.sdf.encoding.hashgrid.dtype=float32")
    arrays = TorchDataset(tcfg).as_arrays()
    rng = np.random.default_rng(0)
    batch = injected_batch(arrays, rng, tcfg.model.render.rand_rays)
    warm = tcfg.optim.sched.warm_up_end

    jmodel = JaxModel(StaticConfig(jcfg.model), StaticConfig(jcfg.data))
    jcond = jax_make_cond(jcfg.model, jnp.asarray(ITER, jnp.int32), jcfg.max_iter, warm)
    jcond["max_levels"] = MAX_LEVELS
    key = jax.random.PRNGKey(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = perturb_jax_params(jmodel.init(key, jbatch, jcond, key, train=True)["params"], rng)

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, jcond, key, train=True)
        return _loss(jax_losses, out, jbatch["image_sampled"]), out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, params))

    tmodel = TorchModel(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(params_from_jax(params))
    tcond = torch_make_cond(tcfg.model, ITER, tcfg.max_iter, warm)
    tcond["max_levels"] = MAX_LEVELS
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tout = tmodel(tbatch, tcond, train=True)
    tl = _loss(torch_losses, tout, tbatch["image_sampled"])
    tl.backward()
    return dict(jcfg=jcfg, tcfg=tcfg, jl=float(jl), tl=tl.item(),
                jout={k: np.asarray(v) for k, v in jout.items() if v is not None},
                tout={k: v.detach().numpy() for k, v in tout.items() if v is not None},
                jgrads={k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()},
                tmodel=tmodel)


def test_dataset_arrays_match():
    jcfg, tcfg = configs()
    want = JaxDataset(jcfg).as_arrays()
    got = TorchDataset(tcfg).as_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_param_names_and_shapes_match(parity):
    got = {k: tuple(v.shape) for k, v in parity["tmodel"].state_dict().items()}
    want = {k: tuple(v.shape) for k, v in parity["jgrads"].items()}
    assert got == want


@pytest.mark.parametrize("key", ["rgb", "weights", "dists", "gradients", "outside"])
def test_outputs_match(parity, key):
    got, want = parity["tout"][key], parity["jout"][key]
    assert got.shape == want.shape
    # float32 outputs; gradients are tap differences over eps, which scales
    # the taps' rounding up but stays inside 1e-5.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_hessians_match(parity):
    """A hessian is (sum of taps / 2 - 2 * center) / h^2 with h^2 = 1/243 at
    this size: one float32 ulp of the ~0.5 SDF values (6e-8) becomes 1.5e-5,
    and the MLPs sum in another order. Compared at 1e-4 of the largest
    value, on rays inside the bounding sphere (outside rays carry the
    constant 1000 SDF and are masked out of the loss)."""
    got, want = parity["tout"]["hessians"], parity["jout"]["hessians"]
    inside = ~parity["jout"]["outside"][..., 0]
    assert got.shape == want.shape and inside.any()
    assert_close_to_leaf_max(got[inside], want[inside], 1e-4, "hessians")


def test_loss_matches(parity):
    np.testing.assert_allclose(parity["tl"], parity["jl"], rtol=1e-6)


def test_param_grads_match(parity):
    """Each leaf's gradient within 1e-3 of that leaf's largest entry: the
    sums over rays and samples run in another order."""
    grads = parity["jgrads"]
    for name, p in parity["tmodel"].named_parameters():
        assert_close_to_leaf_max(p.grad.numpy(), grads[name], 1e-3, name)
    assert all(parity["tmodel"].neural_sdf.hash_table[lv].grad.abs().max() > 0 for lv in range(4))


def test_unported_branch_names_its_key():
    _, tcfg = configs("--model.object.sdf.gradient.shared_levels=2")
    with pytest.raises(NotImplementedError, match="model.object.sdf.gradient.shared_levels"):
        TorchModel(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))
