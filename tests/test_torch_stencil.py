"""The port's shared-level stencil and blocked dense levels
(mlinerf_tpu_torch/ops/hashgrid.py ``encode_stencil``, ``dense_blocked``)
against the JAX package's ``ops/hashgrid.encode_stencil`` on the same numpy
inputs: forward features and table gradients for shared_levels 0, 2, L and
auto (L - 1) x 4 and 6 taps x blocked dense levels off and on, on float32
and bfloat16 tables; and, inside the port, the exactness the stencil and the
blocked tables promise; and the model's exact-hessian pass on the strided
subset (``gradient.hessian.mode: exact``) against the JAX model's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_model_pair_close, configs, model_pair

from mlinerf_tpu.models.fields import numerical_gradient_taps as jax_taps
from mlinerf_tpu.ops import hashgrid as jhg
from mlinerf_tpu_torch.ops import hashgrid as thg

# Resolutions 5, 9, 17, 33 over [-1, 1]: levels 0-1 dense (blocked when
# dense_blocked is on), levels 2-3 hashed into 2^10 rows.
SPEC = dict(num_levels=4, features_per_level=2, log2_hashmap_size=10, min_logres=2, max_logres=5,
            range_min=-1.0, range_max=1.0)
L = SPEC["num_levels"]
SHARED = {"0": 0, "2": 2, "L": L, "auto": L - 1}  # auto: every level but the finest


def _specs(dtype):
    return jhg.HashGridSpec(**SPEC, dtype=dtype), thg.HashGridSpec(**SPEC, dtype=dtype)


def _inputs(jspec, seed, n=60):
    rng = np.random.default_rng(seed)
    dtype = jnp.dtype(jspec.dtype)
    tables = [np.asarray(jnp.asarray(rng.uniform(-1, 1, (s, jspec.features_per_level)), dtype))
              for s in jspec.table_sizes]
    points = rng.uniform(-0.97, 0.97, (3, n // 3, 3)).astype(np.float32)
    return tables, points


def _torch_tables(tables, requires_grad=False):
    out = []
    for t in tables:
        tt = torch.from_numpy(np.array(t, np.float32))
        if t.dtype.name == "bfloat16":
            tt = tt.to(torch.bfloat16)
        out.append(tt.requires_grad_(requires_grad))
    return out


def _taps(taps):
    """The model's tap offsets at eps = one finest cell (1/32 here)."""
    return np.asarray(jax_taps(taps, jnp.float32(1 / 32)), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked"])
@pytest.mark.parametrize("taps", [4, 6])
@pytest.mark.parametrize("shared", sorted(SHARED))
def test_encode_stencil_matches_jax(shared, taps, blocked, dtype):
    """Forward and table gradients of a random cotangent. float32 tables:
    features within 1e-6, gradients within 1e-6 of each leaf's largest
    entry (float32 sums in another order). bfloat16 tables: features within
    one bf16 ulp; the JAX package sums each row's gradient in bf16 (the port
    in f32, rounded once), so gradients within 2^-5 of the leaf's largest."""
    jspec, tspec = _specs(dtype)
    tables, points = _inputs(jspec, seed=taps + 10 * blocked)
    offsets = _taps(taps)
    cot = np.random.default_rng(1).normal(0, 1, (*points.shape[:-1], taps + 1, jspec.output_dim)).astype(np.float32)
    kw = dict(shared_levels=SHARED[shared], dense_blocked=blocked)

    def jloss(tabs):
        out = jhg.encode_stencil(tabs, jnp.asarray(points), jnp.asarray(offsets), jspec, **kw)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(tuple(jnp.asarray(t) for t in tables))
    tt = _torch_tables(tables, requires_grad=True)
    got = thg.encode_stencil(tt, torch.from_numpy(points), torch.from_numpy(offsets), tspec, **kw)
    assert got.shape == (*points.shape[:-1], taps + 1, jspec.output_dim) and got.dtype == tt[0].dtype
    (got.float() * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2**-7, atol=1e-6)
    rtol = 1e-6 if dtype == "float32" else 2**-5
    for lv, (t, g) in enumerate(zip(tt, jgrads)):
        g = np.asarray(g, np.float32)
        assert t.grad.dtype == t.dtype
        err = np.abs(t.grad.float().numpy() - g).max()
        assert err <= rtol * np.abs(g).max(), (lv, err, np.abs(g).max())


def test_stencil_level_mask_and_max_levels_match_jax():
    jspec, tspec = _specs("float32")
    tables, points = _inputs(jspec, seed=3)
    offsets = _taps(4)
    mask = np.asarray([1, 0, 1, 1], np.float32)
    for max_levels in (None, 3, 1):
        want = np.asarray(jhg.encode_stencil(tuple(jnp.asarray(t) for t in tables), jnp.asarray(points),
                                             jnp.asarray(offsets), jspec, level_mask=jnp.asarray(mask),
                                             shared_levels=2, max_levels=max_levels, dense_blocked=True))
        got = thg.encode_stencil(_torch_tables(tables), torch.from_numpy(points), torch.from_numpy(offsets),
                                 tspec, level_mask=mask, shared_levels=2, max_levels=max_levels,
                                 dense_blocked=True).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        cap = L if max_levels is None else max_levels
        assert not got[..., 2 * cap:].any() and not got[..., 2:4].any()


def _in_cell_dyadic(rng, n):
    """Points whose position in the finest cell is in [0.3, 0.7] on every
    axis, on a 1/1024 grid, and tap offsets of at most 40/4096 (0.16 of a
    finest cell), multiples of 1/4096: every tap stays in the centre's cell
    at every level (the resolutions nest: 4, 8, 16, 32 cells), and every
    normalized coordinate and fraction is exact in float32."""
    cells = rng.integers(0, 32, (n, 3))
    frac = rng.integers(20, 45, (n, 3)) / 64  # in [0.3125, 0.7]
    points = (-1 + (cells + frac) / 16).astype(np.float32)
    offsets = (rng.integers(-40, 41, (6, 3)) / 4096).astype(np.float32)
    return points, offsets


@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked"])
def test_in_cell_taps_bitwise_equal_encode(blocked):
    """Inside the port: every shared level's tap features equal ``encode``
    at the tap, bit for bit, when the taps stay in the centre's cell."""
    _, tspec = _specs("float32")
    tables, _ = _inputs(_specs("float32")[0], seed=4)
    points, offsets = _in_cell_dyadic(np.random.default_rng(5), 200)
    tt = _torch_tables(tables)
    p, o = torch.from_numpy(points), torch.from_numpy(offsets)
    got = thg.encode_stencil(tt, p, o, tspec, shared_levels=L, dense_blocked=blocked)
    want = thg.encode(tt, torch.cat([p[:, None], p[:, None] + o], dim=1), tspec, dense_blocked=blocked)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shared", [0, 2, L])
def test_center_bitwise_equal_encode(shared):
    """The centre evaluation is ``encode`` at the point for any offsets,
    even taps many cells wide."""
    jspec, tspec = _specs("bfloat16")
    tables, points = _inputs(jspec, seed=6)
    offsets = np.random.default_rng(7).uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    tt = _torch_tables(tables)
    got = thg.encode_stencil(tt, torch.from_numpy(points), torch.from_numpy(offsets), tspec, shared_levels=shared)
    assert torch.equal(got[..., 0, :], thg.encode(tt, torch.from_numpy(points), tspec))


def test_blocked_table_layout_matches_jax():
    jspec, tspec = _specs("float32")
    tables, _ = _inputs(jspec, seed=8)
    for lv in (0, 1):
        res = jspec.resolutions[lv]
        want = np.asarray(jhg._blocked_dense_table(jnp.asarray(tables[lv]), res, jhg._corner_indices(jspec)))
        got = thg.blocked_dense_table(torch.from_numpy(tables[lv]), res).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shared", [None, 0, 2], ids=["encode", "stencil0", "stencil2"])
def test_blocked_bitwise_forward_and_gradients(shared):
    """Blocked dense levels against the 8-row gather inside the port:
    the forward bitwise; the gradients are the same sums in another order
    (a cell's rows summed, then the 8 slices added), within 1e-6 of each
    leaf's largest entry."""
    _, tspec = _specs("float32")
    tables, points = _inputs(_specs("float32")[0], seed=9)
    offsets = torch.from_numpy(_taps(4))
    cot = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (*points.shape[:-1], 5, 8)).astype(np.float32))
    runs = {}
    for blocked in (False, True):
        tt = _torch_tables(tables, requires_grad=True)
        if shared is None:
            out = thg.encode(tt, torch.from_numpy(points), tspec, dense_blocked=blocked)
            (out * cot[..., 0, :]).sum().backward()
        else:
            out = thg.encode_stencil(tt, torch.from_numpy(points), offsets, tspec, shared_levels=shared,
                                     dense_blocked=blocked)
            (out * cot).sum().backward()
        runs[blocked] = (out.detach(), [t.grad for t in tt])
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_exact_hessian_on_the_strided_subset_matches_jax():
    """shared_levels: L with hessian.mode exact (fraction 0.25): the hessians
    are every 4th sample's, from exact taps, masked outside the bounds.
    With every level shared the finest level's taps leave their cell: its
    extrapolated weights (both signs, up to 2 in size) cancel in the
    features' sums, and the gradients' division by eps scales that
    rounding, so the outputs are held within 1e-4."""
    jcfg, tcfg = configs("--model.object.sdf.encoding.hashgrid.dtype=float32",
                         "--model.object.sdf.gradient.shared_levels=4", "--model.object.sdf.gradient.hessian.mode=exact")
    pair = model_pair(jcfg, tcfg, max_levels=4)
    assert_model_pair_close(pair, out_atol=1e-4)
    got, want = pair["tout"]["hessians"], pair["jout"]["hessians"]
    assert got.shape == want.shape == (1, 64, 5, 3)
    inside = ~pair["jout"]["outside"][..., 0]
    np.testing.assert_allclose(got[inside], want[inside], rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("E", [1, 5])
def test_combine_gradients_pass_gradcheck(E):
    """The fixed-order combine's backward against finite differences (float64),
    for the corner rows and for the weights (which keep the rows only then)."""
    g = torch.Generator().manual_seed(E)
    feats = torch.randn(8, 7, 3, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(8, E, 7, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(thg._Combine.apply, (feats, w))
    out = thg._Combine.apply(feats, w)
    torch.testing.assert_close(out, torch.einsum("cpf,cep->epf", feats, w), rtol=1e-12, atol=1e-12)
