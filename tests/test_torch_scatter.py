"""The port's table-gradient scatter-add (mlinerf_tpu_torch/ops/
hashgrid_scatter.py) against the JAX package's Pallas kernel, which runs in
interpret mode on the CPU (mlinerf_tpu/ops/hashgrid_pallas.py).

The cuda-marked tests hold the CUDA kernel against the plain version on a
card: ``python3 -m pytest -m cuda tests/test_torch_scatter.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlinerf_tpu.ops import hashgrid_pallas as hp
from mlinerf_tpu_torch.ops import hashgrid_scatter
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


def _indices(pattern, S, N, rng, negative=True):
    """Row indices [N] int32 with the structure the kernel's run merging
    must handle. ``negative`` adds dropped rows below 0 (the Pallas kernel
    drops only rows >= S)."""
    if pattern == "uniform":
        return rng.integers(0, S, N).astype(np.int32)
    if pattern == "one_row":
        return np.full(N, 7, np.int32)
    if pattern == "long_runs":  # runs of 1-64 equal rows, across warp boundaries
        k = N // 8
        return np.repeat(rng.integers(0, S, k), rng.integers(1, 65, k))[:N].astype(np.int32)
    if pattern == "dropped_runs":  # kept runs of one row between runs of dropped rows
        drop = [S, S + 5, -1] if negative else [S, S + 5]
        k = N // 10
        rows = np.stack([np.full(k, 3), np.resize(drop, k)], axis=1).reshape(-1)
        lens = np.stack([rng.integers(1, 40, k), rng.integers(1, 6, k)], axis=1).reshape(-1)
        return np.repeat(rows, lens)[:N].astype(np.int32)
    raise ValueError(pattern)


PATTERNS = ("uniform", "one_row", "long_runs", "dropped_runs")
VAL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", sorted(VAL_DTYPES))
@pytest.mark.parametrize("F", [2, 8, 16, 32, 64])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_scatter_add_rows_cases_match_pallas(pattern, F, dtype):
    """f32 and bf16 vals, F = 2, 8, 16, 32, 64 (a blocked dense level's row
    is 8F) and run-structured indices against the Pallas kernel, which
    casts bf16 vals to f32 before it sums."""
    rng = np.random.default_rng(5)
    S, N = 300, 2007  # N not a multiple of a warp
    idx = _indices(pattern, S, N, rng, negative=False)
    vals = torch.from_numpy(rng.normal(0, 1, (N, F)).astype(np.float32)).to(VAL_DTYPES[dtype])
    got = scatter_add_rows(torch.from_numpy(idx), vals, S)
    assert got.dtype == torch.float32 and got.shape == (S, F)
    jvals = jnp.asarray(vals.float().numpy(), jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = np.asarray(hp.scatter_add_rows(jnp.asarray(idx), jvals, S))
    # float32 sums of up to N terms of bf16- or f32-valued N(0,1), in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-4)


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


def test_scatter_add_rows_drops_negative_rows():
    rng = np.random.default_rng(6)
    S, N, F = 64, 1001, 8
    idx = _indices("dropped_runs", S, N, rng)
    assert (idx < 0).any() and (idx >= S).any()
    vals = rng.integers(-8, 9, (N, F)).astype(np.float32)
    want = np.zeros((S, F), np.float32)
    keep = (idx >= 0) & (idx < S)
    np.add.at(want, idx[keep], vals[keep])
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), S)
    np.testing.assert_array_equal(got.numpy(), want)  # integer sums: exact in any order


@pytest.mark.parametrize("bad", ["float64_vals", "int64_idx", "three_features", "strided_vals"])
def test_scatter_add_rows_rejects(bad):
    idx = torch.zeros(6, dtype=torch.int32)
    vals = torch.ones(6, 8)
    if bad == "float64_vals":
        vals = vals.double()
    elif bad == "int64_idx":
        idx = idx.long()
    elif bad == "three_features":
        vals = torch.ones(6, 3)
    else:
        vals = torch.ones(6, 16)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        scatter_add_rows(idx, vals, 4)


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


def test_take_rows_bf16_table(monkeypatch):
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
    # The cotangent reaches scatter_add_rows in bf16: no f32 copy is made.
    seen = []

    def recording(idx_, vals_, size):
        seen.append(vals_.dtype)
        return scatter_add_rows(idx_, vals_, size)

    monkeypatch.setattr(hashgrid_scatter, "scatter_add_rows", recording)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert seen == [torch.bfloat16]
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
@pytest.mark.parametrize("dtype", sorted(VAL_DTYPES))
@pytest.mark.parametrize("F", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_scatter_add_rows_kernel_matches_plain(require_cuda, pattern, F, dtype):
    """On the card: the CUDA kernel against the plain version, on the CPU
    cases at the path's size, with rows outside the table on both sides.
    The values are multiples of 1/4 whose sums stay below 2^22, so every
    order of summation gives the same float32 result."""
    rng = np.random.default_rng(4)
    S, N = 33**3, (1 << 20) + 7
    idx = torch.from_numpy(_indices(pattern, S, N, rng)).cuda()
    vals = torch.from_numpy((rng.integers(-8, 9, (N, F)) / 4).astype(np.float32)).cuda().to(VAL_DTYPES[dtype])
    before = hashgrid_scatter.launches
    got = scatter_add_rows(idx, vals, S)
    torch.cuda.synchronize()
    assert hashgrid_scatter.launches == before + 1
    want = scatter_add_rows_reference(idx, vals, S)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_ingp_backward_launches_the_kernel_per_level(require_cuda):
    """On the card (TF32 off): the TINY Instant-NGP model's backward
    (configs/ingp_blender.yaml, L4 F4 dict 12, float32 MLPs) launches the
    kernel once per level, and its loss, outputs and gradients match the
    same weights on the CPU (loss 1e-5 relative, outputs 1e-4, gradients
    1e-3 of the leaf max)."""
    from torch_parity import INGP_TINY, assert_close_to_leaf_max

    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.data.synthetic import look_at_pose
    from mlinerf_tpu_torch.utils.misc import no_tf32

    cfg = Config("configs/ingp_blender.yaml", cli_args=INGP_TINY + ["--trainer.amp_config.enabled!"])
    rng = np.random.default_rng(7)
    R = cfg.model.rand_rays
    batch = dict(pose=torch.from_numpy(look_at_pose(np.asarray([0.5, -3.9, 1.0], np.float32)).astype(np.float32))[None],
                 intr=torch.tensor([[[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]]),
                 ray_idx=torch.from_numpy(rng.permutation(256)[:R][None]),
                 target=torch.from_numpy(rng.uniform(0, 1, (1, R, 3)).astype(np.float32)))
    model = resolve("model", "ingp")(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t in model.nerf.hash_table:
            t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
    runs = {}
    for device in ("cpu", "cuda"):
        model.zero_grad(set_to_none=True)
        model.to(device)
        before = hashgrid_scatter.launches
        with no_tf32():
            out = model({k: v.to(device) for k, v in batch.items()}, train=True)
            loss = torch.mean((out["rgb"] - batch["target"].to(device)) ** 2)
            loss.backward()
        torch.cuda.synchronize()
        runs[device] = (loss.item(), {k: v.detach().cpu() for k, v in out.items()},
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                        hashgrid_scatter.launches - before)
    cpu, gpu = runs["cpu"], runs["cuda"]
    assert cpu[3] == 0 and gpu[3] == cfg.model.posenc.hashgrid.levels
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
    for key in cpu[1]:
        torch.testing.assert_close(gpu[1][key], cpu[1][key], rtol=0, atol=1e-4)
    for name, g in cpu[2].items():
        assert_close_to_leaf_max(gpu[2][name].numpy(), g.numpy(), 1e-3, name)
