"""The port's vanilla NeRF (mlinerf_tpu_torch/models/nerf.py and the utils
it adds) against the JAX package on the CPU: positional encoding, the NeRF
quadrature weights, NDC rays, and one training forward and backward of the
model (coarse only, coarse + fine with the JAX side's random draws, bf16
mixed precision, NDC), plus the inference chunk's depth.

Tolerances: float32 outputs within 1e-5, the loss within 1e-5 (relative)
and every gradient within 1e-4 of its leaf's largest entry. Under bf16
the outputs within 1e-3, weight gradients within 2% of the leaf max, and
bias gradients within 25%: the JAX package on the CPU sums a bias's bf16
cotangent over the batch in bf16 (several ulps off the float32-accumulated
sum that torch takes), so the bias is the loosest leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_nerf_pair_close, nerf_pair

from mlinerf_tpu.utils import camera as jax_camera
from mlinerf_tpu.utils import encoding as jax_enc
from mlinerf_tpu.utils import render as jax_render
from mlinerf_tpu_torch.utils import camera, encoding, render

BLENDER = "configs/nerf_blender.yaml"
LLFF = "configs/nerf_llff.yaml"


@pytest.mark.parametrize("num_freq", [2, 4, 10])
def test_positional_encoding(num_freq):
    """At L = 10 the top frequency is 512 pi: sin and cos of arguments up
    to ~3e3 round their reductions differently, within 2e-5 at that size."""
    x = np.random.default_rng(num_freq).uniform(-2, 2, (64, 3)).astype(np.float32)
    want = np.asarray(jax_enc.positional_encoding(jnp.asarray(x), num_freq))
    got = encoding.positional_encoding(torch.from_numpy(x), num_freq).numpy()
    assert got.shape == want.shape == (64, 6 * num_freq)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if num_freq == 10 else 1e-6)


@pytest.mark.parametrize("fn", ["volume_rendering_weights_dist", "volume_rendering_alphas_dist"])
def test_volume_rendering_weights(fn):
    """Weights and alphas from densities at sorted distances, the last
    interval 1e10; within 1e-6."""
    rng = np.random.default_rng(1)
    dens = rng.uniform(0, 3, (2, 8, 24)).astype(np.float32)
    dists = np.sort(rng.uniform(2, 6, (2, 8, 24, 1)), axis=-2).astype(np.float32)
    want = np.asarray(getattr(jax_render, fn)(jnp.asarray(dens), jnp.asarray(dists)))
    got = getattr(render, fn)(torch.from_numpy(dens), torch.from_numpy(dists)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_convert_ndc():
    """Rays of two forward-facing cameras to NDC; within 1e-6 relative."""
    rng = np.random.default_rng(2)
    center = np.concatenate([rng.normal(0, 0.1, (2, 32, 2)), rng.uniform(-0.2, 0.2, (2, 32, 1))], -1)
    ray = np.concatenate([rng.normal(0, 0.3, (2, 32, 2)), -np.ones((2, 32, 1))], -1)
    intr = np.asarray([[[400.0, 0, 252], [0, 410.0, 189], [0, 0, 1]]] * 2)
    args = [a.astype(np.float32) for a in (center, ray, intr)]
    want = jax_camera.convert_NDC(*map(jnp.asarray, args[:2]), intr=jnp.asarray(args[2]))
    got = camera.convert_NDC(*map(torch.from_numpy, args[:2]), intr=torch.from_numpy(args[2]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


CASES = {
    # coarse only, the inverse distance parametrisation
    "coarse_inverse": (BLENDER, ["--model.fine_sampling!", "--model.dist.param=inverse"], {}),
    # coarse + fine, stratified jitter and density noise drawn by JAX
    "fine_draws": (BLENDER, ["--model.sample_stratified", "--model.density_noise_reg=1.0"], dict(draws=True)),
    # coarse + fine, bf16 MLPs
    "fine_bf16": (BLENDER, [], dict(amp=True)),
    # NDC rays (nerf_llff), coarse + fine
    "ndc": (LLFF, [], {}),
}


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, case):
    if case not in pairs:
        config, extra, kwargs = CASES[case]
        pairs[case] = nerf_pair(config, *extra, **kwargs)
    return pairs[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_nerf_model_matches_jax(pairs, case):
    pair = _pair(pairs, case)
    if CASES[case][2].get("amp"):
        assert_nerf_pair_close(pair, loss_rtol=1e-4, out_atol=1e-3, grad_rtol=2e-2, bias_grad_rtol=0.25)
    else:
        assert_nerf_pair_close(pair, loss_rtol=1e-5, out_atol=1e-5, grad_rtol=1e-4)
    assert all(np.isfinite(v).all() for v in pair["tout"].values())
    fine = "rgb_fine" in pair["tout"]
    assert fine == (case != "coarse_inverse")
    # Each field's parameters get a gradient, the fine field's through its own loss.
    names = [n for n, p in pair["tmodel"].named_parameters() if float(p.grad.abs().max()) > 0]
    assert any(n.startswith("nerf.") for n in names) and fine == any(n.startswith("nerf_fine.") for n in names)


def test_render_chunk_matches_jax(pairs):
    """The inference chunk (midpoint samples, no noise) with its depths, on
    the fine_draws case's params; within 1e-5."""
    pair = _pair(pairs, "fine_draws")
    jmodel, params = pair["jmodel"], jax.tree.map(jnp.asarray, pair["params"])
    rng = np.random.default_rng(3)
    center = np.broadcast_to(np.asarray([0.5, -3.9, 1.0], np.float32), (1, 24, 3)).copy()
    ray = (-center + rng.normal(0, 0.3, (1, 24, 3))).astype(np.float32)
    want = jax.jit(lambda p, c, r: jmodel.apply({"params": p}, c, r, method=jmodel.render_chunk))(
        params, jnp.asarray(center), jnp.asarray(ray))
    with torch.no_grad():
        got = pair["tmodel"].render_chunk(torch.from_numpy(center), torch.from_numpy(ray))
    assert sorted(got) == sorted(want) and "depth_fine" in got
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5, err_msg=key)
