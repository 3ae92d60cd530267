"""The port's corner-sampled table gradient (mlinerf_tpu_torch/ops/
hashgrid.py ``CornerSampledCombine``, ``CornerSampling``) against the JAX
package's ``ops/hashgrid.corner_sampled_combine`` on JAX's own uniforms,
and its own claims (mirroring tests/test_corner_sample.py): the forward is
the exact combine, the table gradient is unbiased, top1cot has less
variance than cotangent and cotangent than center, and it scatters at most
1 + k rows per point; and a training forward and backward of the
syn_e2e_a semantics with top1cot on JAX's uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_model_pair_close, configs, model_pair

from mlinerf_tpu.ops import hashgrid as jhg
from mlinerf_tpu_torch.ops import hashgrid as thg

MODES = ("center", "cotangent", "top1cot")
E2E = "configs/syn_e2e_a.yaml"
# As tests/test_torch_e2e.py: two dense levels, 3 live levels (2 shared),
# sampling on 2.
E2E_TINY = ["--model.object.sdf.encoding.hashgrid.dict_size=13",
            "--model.object.sdf.encoding.coarse2fine.init_active_level=3", "--model.render.sampling_levels=2"]


def _problem(seed, E=1, S=32, P=48, F=4, signed=False):
    """A table, corner rows [8,P] and weights [E,8,P]; ``signed``: the
    stencil's case, evaluation 0 a trilinear and the rest extrapolations
    (signed weights that still sum to 1)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (S, F)).astype(np.float32)
    idx = rng.integers(0, S, (8, P)).astype(np.int32)
    if signed:
        f = rng.uniform(-0.5, 1.5, (E, 3, P)).astype(np.float32)
        f[0] = np.clip(f[0], 0, 1)
        corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float32)
        w = np.ones((E, 8, P), np.float32)
        for ax in range(3):
            d = corners[:, ax][None, :, None]
            w = w * np.where(d == 1, f[:, ax][:, None, :], 1 - f[:, ax][:, None, :])
    else:
        w = rng.uniform(0, 1, (E, 8, P)).astype(np.float32)
        w = w / w.sum(1, keepdims=True)
    ct = rng.normal(0, 1, (E, P, F)).astype(np.float32)
    return table, idx, w, ct


def _port_grad(table, idx, w, ct, u, mode, k, floor=0.125):
    t = torch.from_numpy(table).requires_grad_(True)
    out = thg.CornerSampledCombine.apply(t, torch.from_numpy(idx), torch.from_numpy(w),
                                         lambda: torch.from_numpy(np.asarray(u)), floor, k, mode)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("signed", [False, True], ids=["trilinear", "stencil"])
def test_gradient_matches_jax_on_its_uniforms(signed, k, mode):
    """The same draw as the JAX package (its uniforms passed in): the same
    corners picked, so the table gradients agree to float32 rounding
    (within 1e-5 of the largest entry); the forward is the exact combine."""
    E = 5 if signed else 1
    table, idx, w, ct = _problem(k + 3 * signed, E=E, signed=signed)
    key = jax.random.PRNGKey(11)

    def loss(t):
        out = jhg.corner_sampled_combine(t, jnp.asarray(idx), jnp.asarray(w), key, k_samples=k, mode=mode)
        return jnp.sum(out * jnp.moveaxis(jnp.asarray(ct), 1, 2)), out

    (_, jout), jgrad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(table))
    u = jax.random.uniform(key, (k, idx.shape[1]), jnp.float32)
    out, grad = _port_grad(table, idx, w, ct, u, mode, k)
    np.testing.assert_allclose(out, np.moveaxis(np.asarray(jout), 1, 2), rtol=1e-6, atol=1e-6)
    jgrad = np.asarray(jgrad)
    assert np.abs(grad - jgrad).max() <= 1e-5 * np.abs(jgrad).max()
    assert ((grad != 0).any(-1) == (jgrad != 0).any(-1)).all()  # the same rows touched


def _replicated(table, idx, w, ct, n):
    """n copies of the problem, copy j on its own table rows idx + j*S:
    one backward gives n independent draws' gradients, [n,S,F]."""
    S, P = table.shape[0], idx.shape[1]
    idx_n = (idx[:, None, :] + (np.arange(n) * S)[None, :, None]).reshape(8, n * P).astype(np.int32)
    return (np.tile(table, (n, 1)), idx_n, np.tile(w, (1, 1, n)), np.tile(ct, (1, n, 1)))


def _draws(table, idx, w, ct, mode, k, n, seed):
    t, i, ww, c = _replicated(table, idx, w, ct, n)
    u = torch.rand(k, i.shape[1], generator=torch.Generator().manual_seed(seed))
    _, g = _port_grad(t, i, ww, c, u, mode, k)
    return g.reshape(n, *table.shape)


def _exact_grad(table, idx, w, ct):
    g = np.zeros_like(table)
    v = np.einsum("ecp,epf->cpf", w, ct)
    np.add.at(g, idx.reshape(-1), v.reshape(-1, table.shape[1]))
    return g


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("signed", [False, True], ids=["trilinear", "stencil"])
def test_gradient_unbiased(signed, k, mode):
    """The mean over 4000 draws is the exact gradient: every entry within
    5 standard errors of the mean (the estimator's own spread, measured
    over the draws; the centre mode on signed weights spreads widely)."""
    table, idx, w, ct = _problem(20 + k, E=5 if signed else 1, signed=signed)
    n = 4000
    g = _draws(table, idx, w, ct, mode, k, n, seed=k)
    exact = _exact_grad(table, idx, w, ct)
    stderr = g.std(0) / np.sqrt(n)
    err = np.abs(g.mean(0) - exact)
    assert np.all(err <= 5 * stderr + 1e-5 * np.abs(exact).max()), float((err / (stderr + 1e-12)).max())


def test_variance_order_on_the_stencil():
    """Signed tap weights: the cotangent-norm sampler has under half the
    variance of the centre-weight one, and top1cot under half of that."""
    table, idx, w, ct = _problem(4, E=5, signed=True)
    var = {m: float(_draws(table, idx, w, ct, m, 1, 800, seed=5).var(0).sum()) for m in MODES}
    assert var["cotangent"] < 0.5 * var["center"], var
    assert var["top1cot"] < 0.5 * var["cotangent"], var


@pytest.mark.parametrize("mode,rows", [("cotangent", 1), ("top1cot", 2)])
def test_rows_per_point(mode, rows):
    table, idx, w, _ = _problem(6)
    ct = np.ones((1, idx.shape[1], table.shape[1]), np.float32)
    u = torch.rand(1, idx.shape[1], generator=torch.Generator().manual_seed(0))
    _, g = _port_grad(table, idx, w, ct, u, mode, 1)
    assert (g != 0).any(-1).sum() <= rows * idx.shape[1]


def _jax_stream_draw(key):
    """A ``CornerSampling.draw`` that hands back the JAX package's uniforms
    for each lookup (its key folded with the lookup's stream)."""

    def draw(stream, shape, device):
        return torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(key, stream), shape, jnp.float32)))

    return draw


@pytest.mark.parametrize("exact_finest", [0, 1])
@pytest.mark.parametrize("stencil", [False, True], ids=["encode", "stencil"])
def test_encode_with_corner_sampling_matches_jax(stencil, exact_finest):
    """Through the encoders, with JAX's draw for every level (and, on the
    stencil's exact levels, every evaluation): features within 1e-6, each
    level's table gradient within 1e-5 of its largest entry; with
    exact_finest the finest level's gradient is the exact one."""
    spec_kw = dict(num_levels=4, features_per_level=2, log2_hashmap_size=8, min_logres=2, max_logres=5)
    jspec, tspec = jhg.HashGridSpec(**spec_kw), thg.HashGridSpec(**spec_kw)
    rng = np.random.default_rng(7)
    tables = [rng.uniform(-1, 1, (s, 2)).astype(np.float32) for s in jspec.table_sizes]
    pts = rng.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    offsets = (np.array([[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], np.float32) * 0.02)
    key = jax.random.PRNGKey(3)
    kw = dict(corner_mode="top1cot", corner_exact_finest=exact_finest)

    def jencode(tabs, **extra):
        if stencil:
            return jhg.encode_stencil(tabs, jnp.asarray(pts), jnp.asarray(offsets), jspec, shared_levels=2, **extra)
        return jhg.encode(tabs, jnp.asarray(pts), jspec, **extra)

    def jloss(tabs, **extra):
        return jnp.sum(jnp.sin(jencode(tabs, **extra))), jencode(tabs, **extra)

    (_, want), jgrads = jax.value_and_grad(lambda t: jloss(t, corner_key=key, **kw), has_aux=True)(
        tuple(jnp.asarray(t) for t in tables))
    jexact = jax.grad(lambda t: jloss(t)[0])(tuple(jnp.asarray(t) for t in tables))
    tt = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    corner = thg.CornerSampling(_jax_stream_draw(key), mode="top1cot", exact_finest=exact_finest)
    if stencil:
        got = thg.encode_stencil(tt, torch.from_numpy(pts), torch.from_numpy(offsets), tspec, shared_levels=2,
                                 corner=corner)
    else:
        got = thg.encode(tt, torch.from_numpy(pts), tspec, corner=corner)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for lv, (t, g) in enumerate(zip(tt, jgrads)):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max(), lv
    if exact_finest:
        np.testing.assert_allclose(tt[-1].grad.numpy(), np.asarray(jexact[-1]), rtol=1e-5, atol=1e-6)
        assert not np.allclose(tt[0].grad.numpy(), np.asarray(jexact[0]))


def test_blocked_dense_levels_supersede_corner_sampling():
    """With both on, a dense level's gradient is the exact one."""
    spec = thg.HashGridSpec(num_levels=3, features_per_level=2, log2_hashmap_size=10, min_logres=2, max_logres=4)
    rng = np.random.default_rng(8)
    tables = [rng.uniform(-1, 1, (s, 2)).astype(np.float32) for s in spec.table_sizes]
    pts = torch.from_numpy(rng.uniform(-1.9, 1.9, (23, 3)).astype(np.float32))
    grads = {}
    for corner in (None, thg.CornerSampling(thg.generator_draw(torch.Generator().manual_seed(0)))):
        tt = [torch.from_numpy(t).requires_grad_(True) for t in tables]
        torch.sin(thg.encode(tt, pts, spec, dense_blocked=True, corner=corner)).sum().backward()
        grads[corner is None] = [t.grad for t in tt]
    for lv in (0, 1):  # dense
        torch.testing.assert_close(grads[False][lv], grads[True][lv], rtol=1e-5, atol=1e-6)
    assert torch.isfinite(grads[False][2]).all() and not torch.equal(grads[False][2], grads[True][2])


def _corner_draw_of_jax(key):
    """The port's corner uniforms as the JAX package draws them in a
    training render on ``key``: its corner key is ``fold_in(key, 0x5A11)``,
    folded again with each lookup's stream."""
    corner_key = jax.random.fold_in(key, 0x5A11)

    def draw(stream, shape, device):
        return torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(corner_key, stream), shape)))

    return draw


def test_corner_sampled_step_matches_jax():
    """top1cot, k = 1, on the syn_e2e_a semantics (float32 tables): on JAX's
    uniforms the port picks the same corners, so the loss, the outputs and
    every gradient agree within the model test's bounds."""
    jcfg, tcfg = configs(*E2E_TINY, "--model.object.sdf.encoding.hashgrid.dtype=float32",
                         "--model.object.sdf.gradient.corner_sample.enabled",
                         "--model.object.sdf.gradient.corner_sample.mode=top1cot", config=E2E)
    pair = model_pair(jcfg, tcfg, max_levels=3,
                      torch_cond={"corner_draw": _corner_draw_of_jax(jax.random.PRNGKey(0))})
    assert_model_pair_close(pair)
