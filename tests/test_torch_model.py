"""The port's Lumen model (mlinerf_tpu_torch/models/lumen.py) against the JAX
package's at the TINY size: the same bridged params, the same rays, midpoint
samples. Covers the dataset, the render outputs, and the gradient of every
parameter for a stage-a loss."""

import numpy as np
import pytest
import torch

from torch_parity import assert_close_to_leaf_max, configs, model_pair

from mlinerf_tpu.data.synthetic import Dataset as JaxDataset
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.models.lumen import Model as TorchModel

ITER = 10
MAX_LEVELS = 4


@pytest.fixture(scope="module")
def parity():
    return model_pair(*configs("--model.object.sdf.encoding.hashgrid.dtype=float32"), iteration=ITER,
                      max_levels=MAX_LEVELS)


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
    _, tcfg = configs()
    with pytest.raises(NotImplementedError, match="trainer.amp_config.enabled"):
        TorchModel(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0), compute_dtype=torch.bfloat16)
