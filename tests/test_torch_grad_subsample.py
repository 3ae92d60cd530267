"""The port's importance-subsampled encoder gradients
(``model.object.sdf.gradient.subsample``, mlinerf_tpu_torch/models/
neuralangelo.py ``eval_field_grad_subsampled``) against the JAX package's
(models/neuralangelo.py): the selected samples, with ties, the loss and the
parameter gradients; and, as tests/test_grad_subsample.py pins for JAX,
that the forward's values are the full path's and that a selection of
every sample gives the full path's gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close_to_leaf_max, assert_model_pair_close, configs, model_pair

from mlinerf_tpu_torch.models.neuralangelo import grad_sample_indices

F32 = "--model.object.sdf.encoding.hashgrid.dtype=float32"


def _sub(topk, stride, enabled=True):
    return ["--model.object.sdf.gradient.subsample.enabled" + ("" if enabled else "!"),
            f"--model.object.sdf.gradient.subsample.topk={topk}",
            f"--model.object.sdf.gradient.subsample.stride={stride}"]


@pytest.mark.parametrize("topk,stride", [(7, 4), (7, 0), (30, 8), (40, 3)])
def test_selected_indices_match_top_k_with_ties(topk, stride):
    """Most weights are 0 (empty space) and the rest repeat, so the order of
    equal weights decides the pick: the port takes them in index order, as
    ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(topk + stride)
    w = rng.choice(np.float32([0, 0, 0, 0.1, 0.25, 0.25, 0.5]), (2, 9, 30)).astype(np.float32)
    got = grad_sample_indices(torch.from_numpy(w), topk, stride).numpy()
    k = min(topk, w.shape[-1])
    want = np.asarray(jax.lax.top_k(jnp.asarray(w), k)[1])
    if stride:
        want = np.concatenate([want, np.broadcast_to(np.arange(0, 30, stride), (2, 9, len(range(0, 30, stride))))], -1)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair():
    return model_pair(*configs(F32, *_sub(6, 4)))


def test_subsampled_path_matches_jax(pair):
    """The loss and outputs within the model test's bounds; each parameter's
    gradient within 1e-3 of its leaf's largest entry. The hessians are the
    selected samples' [B,R,6+5,3]."""
    assert_model_pair_close(pair)
    assert pair["tout"]["hessians"].shape == pair["jout"]["hessians"].shape == (1, 64, 11, 3)


def _port_run(cfg, state, batch):
    """The port's training forward and stage-a backward on ``state``."""
    from mlinerf_tpu_torch.models.lumen import Model
    from mlinerf_tpu_torch.models.neuralangelo import make_cond
    from mlinerf_tpu_torch.utils import losses
    from torch_parity import stage_a_loss

    model = Model(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out = model(batch, make_cond(cfg.model, 10, cfg.max_iter, cfg.optim.sched.warm_up_end), train=True)
    stage_a_loss(losses, out, batch["image_sampled"]).backward()
    return out, {n: p.grad for n, p in model.named_parameters()}


def test_forward_values_are_the_full_paths(pair):
    """Inside the port: the rgb, weights and gradients of the subsampled
    path equal those of the full path (the same numbers, merged)."""
    _, tcfg = configs(F32, *_sub(6, 4, enabled=False))
    full, _ = _port_run(tcfg, pair["tmodel"].state_dict(), pair["batch"])
    for key in ("rgb", "weights", "gradients"):
        np.testing.assert_allclose(pair["tout"][key], full[key].detach().numpy(), rtol=0, atol=1e-6, err_msg=key)


def test_selecting_every_sample_gives_the_full_gradients(pair):
    """topk = all 20 samples, no stride: the same backward, re-indexed;
    every gradient within 1e-5 of its leaf's largest entry."""
    state = pair["tmodel"].state_dict()
    _, grads_all = _port_run(configs(F32, *_sub(20, 0))[1], state, pair["batch"])
    _, grads_off = _port_run(configs(F32, *_sub(20, 0, enabled=False))[1], state, pair["batch"])
    for n, g in grads_off.items():
        assert_close_to_leaf_max(grads_all[n].numpy(), g.numpy(), 1e-5, n)
