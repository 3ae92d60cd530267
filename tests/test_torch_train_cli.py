"""The port's AdamW against optax on equal gradients, and the training CLI
(``python -m mlinerf_tpu_torch.train``) on the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CONFIG, TINY, bf16_ulp, configs

from mlinerf_tpu.trainers.optim import make_optimizer as jax_make_optimizer
from mlinerf_tpu_torch.trainers.optim import make_optimizer
from mlinerf_tpu_torch.utils.misc import get_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))





def test_adamw_matches_optax_with_bf16_leaf():
    """The optimizer alone, fed the same gradients: three AdamW updates of a
    bf16 table and a float32 matrix match optax to one bf16 ulp and float32
    rounding; ``nu`` stays bf16 for the bf16 leaf."""
    from mlinerf_tpu.trainers.optim import make_optimizer as jax_make_optimizer
    from mlinerf_tpu_torch.trainers.optim import make_optimizer

    jcfg, tcfg = configs("--optim.sched.warm_up_end=2")
    rng = np.random.default_rng(3)
    table = jnp.asarray(rng.uniform(-1e-4, 1e-4, (4096, 8)), jnp.bfloat16)
    weight = jnp.asarray(rng.normal(0, 0.3, (64, 32)), jnp.float32)
    tx, _ = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter)
    jparams = {"table": table, "weight": weight}
    state = tx.init(jparams)
    tparams = [torch.from_numpy(np.array(table, np.float32)).to(torch.bfloat16),
               torch.from_numpy(np.array(weight))]
    opt, _ = make_optimizer(tcfg.optim, tparams)
    for _ in range(3):
        g_table = rng.normal(0, 1e-3, table.shape) * (rng.uniform(size=table.shape) > 0.3)
        grads = {"table": jnp.asarray(g_table, jnp.bfloat16),
                 "weight": jnp.asarray(rng.normal(0, 1e-2, weight.shape), jnp.float32)}
        updates, state = tx.update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jparams, updates)
        opt.step([torch.from_numpy(np.array(grads["table"], np.float32)).to(torch.bfloat16),
                  torch.from_numpy(np.array(grads["weight"]))])
    want_table = torch.from_numpy(np.array(jparams["table"], np.float32))
    assert tparams[0].dtype == opt.nu[0].dtype == torch.bfloat16
    assert torch.all((tparams[0].float() - want_table).abs() <= bf16_ulp(tparams[0], want_table))
    assert not torch.equal(tparams[0].float(), torch.from_numpy(np.array(table, np.float32)))
    want_nu = torch.from_numpy(np.array(state[0].nu["table"], np.float32))
    assert torch.all((opt.nu[0].float() - want_nu).abs() <= bf16_ulp(opt.nu[0], want_nu))
    np.testing.assert_allclose(tparams[1].numpy(), np.asarray(jparams["weight"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.mu[0].numpy(), np.asarray(state[0].mu["table"]), rtol=1e-6, atol=1e-12)


def test_train_cli_three_steps(tmp_path):
    logdir = tmp_path / "run"
    cmd = [sys.executable, "-m", "mlinerf_tpu_torch.train", "--config", CONFIG, "--logdir", str(logdir),
           "--device", "cpu", "--max_iter=3", "--logging_iter=1", *TINY]
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=300, capture_output=True)
    records = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["train/total_loss"]) for r in records)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device(None)
