"""The port's table-gradient scatter-add (mlinerf_tpu_torch/ops/
hashgrid_scatter.py) against the JAX package's Pallas kernel, which runs in
interpret mode on the CPU (mlinerf_tpu/ops/hashgrid_pallas.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlinerf_tpu.ops import hashgrid_pallas as hp
from mlinerf_tpu_torch.ops.hashgrid_scatter import (
    TakeRows,
    scatter_add_rows,
    scatter_add_rows_reference,
    take_rows,
)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _both(idx, vals, S):
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), S).numpy()
    want = np.asarray(hp.scatter_add_rows(jnp.asarray(idx), jnp.asarray(vals), S))
    return got, want


def test_scatter_add_rows_matches_pallas():
    rng = np.random.default_rng(0)
    S, F, N = 4096, 8, 20000  # N not a multiple of the Pallas chunk
    idx = rng.integers(0, S, N).astype(np.int32)
    vals = rng.normal(0, 1, (N, F)).astype(np.float32)
    got, want = _both(idx, vals, S)
    assert got.dtype == np.float32 and got.shape == (S, F)
    # float32 sums of ~5 N(0,1) terms per row, in another order: ~1e-6.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_scatter_add_rows_drops_oob():
    S, F = 256, 8
    idx = np.asarray([0, 5, S, S + 7, 5], np.int32)  # two rows outside the table
    vals = np.ones((5, F), np.float32)
    got, want = _both(idx, vals, S)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0 and got[5, 0] == 2.0 and got.sum() == 3 * F


def test_scatter_add_rows_unaligned_table():
    """Dense levels have sizes like 9^3 = 729, not a multiple of 128/F."""
    rng = np.random.default_rng(3)
    S, F, N = 729, 8, 5000
    idx = rng.integers(0, S, N).astype(np.int32)
    vals = rng.normal(0, 1, (N, F)).astype(np.float32)
    got, want = _both(idx, vals, S)
    assert got.shape == (S, F)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_take_rows_grad_matches_jax():
    rng = np.random.default_rng(1)
    S, F, N = 512, 8, 3000
    table = rng.normal(0, 1, (S, F)).astype(np.float32)
    idx = rng.integers(0, S, (N,)).astype(np.int32)
    cot = rng.normal(0, 1, (N, F)).astype(np.float32)

    t = torch.from_numpy(table).requires_grad_(True)
    out = take_rows(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(tab):
        return jnp.sum(hp.take_rows(tab, jnp.asarray(idx)) * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_take_rows_bf16_table():
    """bf16 tables: the forward is the exact gather; the gradient is
    accumulated in f32 and cast to bf16. The JAX reference accumulates in
    bf16, so the two agree to bf16 rounding of sums of ~4 terms."""
    rng = np.random.default_rng(2)
    S, F, N = 256, 8, 1000
    table = jnp.asarray(rng.normal(0, 1, (S, F)), jnp.bfloat16)
    idx = rng.integers(0, S, (N,)).astype(np.int32)
    cot = rng.normal(0, 1, (N, F)).astype(np.float32)

    t = torch.from_numpy(np.asarray(table, np.float32)).to(torch.bfloat16).requires_grad_(True)
    out = TakeRows.apply(t, torch.from_numpy(idx))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jnp.take(table, idx, axis=0), np.float32))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert t.grad.dtype == torch.bfloat16

    def loss(tab):
        return jnp.sum(hp.take_rows(tab, jnp.asarray(idx)).astype(jnp.float32) * cot)

    want = np.asarray(jax.grad(loss)(table), np.float32)
    # The cotangent reaching the gather is bf16 (the backward of the cast).
    cot_bf16 = torch.from_numpy(cot).to(torch.bfloat16).float()
    exact = scatter_add_rows_reference(torch.from_numpy(idx), cot_bf16, S).numpy()
    # The port rounds the f32 sum once: within half a bf16 ulp of it.
    np.testing.assert_allclose(t.grad.float().numpy(), exact, rtol=2**-8, atol=1e-6)
    # bf16 accumulation of ~4 terms: a few bf16 ulps of the row's magnitude.
    np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=2**-5, atol=2**-6)


@pytest.mark.cuda
def test_scatter_add_rows_kernel_matches_plain(require_cuda):
    """On the card: the CUDA kernel against the plain version, with rows
    outside the table. f32 atomics reorder the sums."""
    rng = np.random.default_rng(4)
    S, F, N = 33**3, 8, 1 << 20
    idx = torch.from_numpy(rng.integers(-3, S + 50, N).astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(0, 1, (N, F)).astype(np.float32)).cuda()
    before = scatter_add_rows.launches
    got = scatter_add_rows(idx, vals, S)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    want = scatter_add_rows_reference(idx, vals, S)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
