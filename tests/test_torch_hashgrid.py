"""The port's hash-grid encoder (mlinerf_tpu_torch/ops/hashgrid.py) against
the JAX package's ``ops/hashgrid.encode``: spec tables, dense and hashed
indices (with uint32 wrap-around at dict sizes 19 and 22), level masks and
caps, float32 and bfloat16 tables, and the table gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlinerf_tpu.ops import hashgrid as jhg
from mlinerf_tpu_torch.ops import hashgrid as thg

SPECS = {
    # TINY: dense coarse levels, hashed fine levels.
    "tiny": dict(num_levels=4, features_per_level=2, log2_hashmap_size=12, min_logres=3, max_logres=6),
    # Production resolutions at dict 19: 4 dense + 12 hashed levels.
    "prod_dict19": dict(num_levels=16, features_per_level=2, log2_hashmap_size=19, min_logres=5,
                        max_logres=11),
    # Finest levels at dict 22: iy*2654435761 overflows 32 bits.
    "fine_dict22": dict(num_levels=2, features_per_level=2, log2_hashmap_size=22, min_logres=10,
                        max_logres=11),
}


def _specs(name, dtype="float32"):
    kw = dict(SPECS[name], dtype=dtype)
    return jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)


def _inputs(jspec, seed, P=700):
    rng = np.random.default_rng(seed)
    dtype = jnp.dtype(jspec.dtype)
    tables = [np.asarray(jnp.asarray(rng.uniform(-1, 1, (s, jspec.features_per_level)), dtype))
              for s in jspec.table_sizes]
    # Inside the [-2, 2] range plus a few points beyond it (clamped cells).
    points = rng.uniform(-1.9, 1.9, (P, 3)).astype(np.float32)
    points[:5] = rng.uniform(-2.5, 2.5, (5, 3))
    return tables, points


def _torch_tables(tables, requires_grad=False):
    out = []
    for t in tables:
        tt = torch.from_numpy(np.array(t, np.float32))
        if t.dtype.name == "bfloat16":
            tt = tt.to(torch.bfloat16)
        out.append(tt.requires_grad_(requires_grad))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_tables_match(name):
    jspec, tspec = _specs(name)
    assert tspec.resolutions == jspec.resolutions
    assert tspec.table_sizes == jspec.table_sizes
    assert tspec.level_offsets == jspec.level_offsets
    assert tspec.growth_rate == jspec.growth_rate
    assert tspec.output_dim == jspec.output_dim


def test_prod_spec_shapes():
    """syn_prodscale_a: resolutions 33..2048, levels 0-3 dense."""
    _, spec = _specs("prod_dict19")
    assert spec.resolutions[:5] == (33, 43, 56, 74, 98) and spec.resolutions[-1] == 2048
    assert spec.table_sizes[:4] == (33**3, 43**3, 56**3, 74**3)
    assert set(spec.table_sizes[4:]) == {2**19}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_hash_indices_wrap_like_uint32(name):
    """Corner rows equal a numpy uint32 evaluation of the hash, bit for bit."""
    _, spec = _specs(name)
    _, points = _inputs(_specs(name)[0], seed=5)
    x01 = (torch.from_numpy(points) - spec.range_min) / (spec.range_max - spec.range_min)
    for lv, (res, size) in enumerate(zip(spec.resolutions, spec.table_sizes)):
        idx, weights = thg.level_corners(x01, spec, lv)
        cell = np.clip(np.floor(x01.numpy() * np.float32(res - 1)), 0, res - 2).astype(np.uint32)
        c = np.arange(8)
        corner = np.stack([(c >> 2) & 1, (c >> 1) & 1, c & 1], 1).astype(np.uint32)
        ix, iy, iz = (cell[None, :, a] + corner[:, a:a + 1] for a in range(3))
        if res**3 <= size:
            want = ix + np.uint32(res) * (iy + np.uint32(res) * iz)
        else:
            with np.errstate(over="ignore"):
                want = (ix ^ iy * np.uint32(2654435761) ^ iz * np.uint32(805459861)) % np.uint32(size)
        np.testing.assert_array_equal(idx.numpy(), want.astype(np.int32))
        np.testing.assert_allclose(weights.sum(0).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_encode_matches_jax_f32(name):
    jspec, tspec = _specs(name)
    tables, points = _inputs(jspec, seed=6)
    want = np.asarray(jhg.encode(tuple(jnp.asarray(t) for t in tables), jnp.asarray(points), jspec))
    got = thg.encode(_torch_tables(tables), torch.from_numpy(points), tspec).numpy()
    assert got.shape == want.shape == (len(points), jspec.output_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encode_level_mask_and_max_levels():
    jspec, tspec = _specs("tiny")
    tables, points = _inputs(jspec, seed=7)
    points = points.reshape(7, 100, 3)  # leading dims are kept
    mask = np.asarray([1, 1, 0, 1], np.float32)
    for max_levels in (None, 3, 1):
        want = np.asarray(jhg.encode(tuple(jnp.asarray(t) for t in tables), jnp.asarray(points), jspec,
                                     level_mask=jnp.asarray(mask), max_levels=max_levels))
        got = thg.encode(_torch_tables(tables), torch.from_numpy(points), tspec,
                         level_mask=mask, max_levels=max_levels).numpy()
        assert got.shape == (7, 100, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        cap = 4 if max_levels is None else max_levels
        assert not got[..., cap * 2:].any() and not got[..., 4:6].any()


@pytest.mark.parametrize("name", ["tiny", "prod_dict19"])
def test_encode_matches_jax_bf16(name):
    """bf16 tables: features are combined in f32 and rounded to bf16 once,
    as XLA's CPU einsum does; the sums of 8 products may round across a
    bf16 boundary when their order differs, so one bf16 ulp is allowed."""
    jspec, tspec = _specs(name, "bfloat16")
    tables, points = _inputs(jspec, seed=8)
    want = np.asarray(jhg.encode(tuple(jnp.asarray(t) for t in tables), jnp.asarray(points), jspec),
                      np.float32)
    got_t = thg.encode(_torch_tables(tables), torch.from_numpy(points), tspec)
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_allclose(got_t.float().numpy(), want, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "prod_dict19"])
def test_table_grad_matches_jax(name):
    jspec, tspec = _specs(name)
    tables, points = _inputs(jspec, seed=9, P=500)
    cot = np.random.default_rng(10).normal(0, 1, (len(points), jspec.output_dim)).astype(np.float32)
    mask = np.ones(jspec.num_levels, np.float32)
    mask[-1] = 0.0

    def loss(tabs):
        return jnp.sum(jhg.encode(tabs, jnp.asarray(points), jspec, level_mask=jnp.asarray(mask)) * cot)

    want = jax.grad(loss)(tuple(jnp.asarray(t) for t in tables))
    tt = _torch_tables(tables, requires_grad=True)
    (thg.encode(tt, torch.from_numpy(points), tspec, level_mask=mask) * torch.from_numpy(cot)).sum().backward()
    for lv, (g, w) in enumerate(zip(tt, want)):
        # f32 sums of trilinear-weighted cotangents in another order.
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"level {lv}")
    assert not tt[-1].grad.any()  # the masked level gets a zero gradient
