"""The trainer's runtime options in the port against the JAX package: the
four LR schedules, SGD, RAdam and gradient accumulation (optax.MultiSteps)
on the same gradients, ``trainer.init``, the heatmap and the logger's
image, wandb and TensorBoard sinks, validation images, the stall watchdog,
``train.py --profile``, and resuming a JAX checkpoint with its optax state."""

import io
import os
import pickle
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CONFIG, TINY, JaxSteps, assert_close_to_leaf_max, bf16_ulp, configs, injected_batch

from mlinerf_tpu.config import AttrDict as JaxAttrDict
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu.trainers.optim import make_optimizer as jax_make_optimizer
from mlinerf_tpu.utils import console as jax_console
from mlinerf_tpu.utils.misc import get_schedule as jax_get_schedule
from mlinerf_tpu_torch import train as train_cli
from mlinerf_tpu_torch.bridge import opt_state_from_jax, params_from_jax
from mlinerf_tpu_torch.config import AttrDict
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.trainers.base import MetricsLogger, Watchdog
from mlinerf_tpu_torch.trainers.checkpoint import _JaxCheckpointUnpickler
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer
from mlinerf_tpu_torch.trainers.optim import AdamW, MultiSteps, make_optimizer
from mlinerf_tpu_torch.utils import console
from mlinerf_tpu_torch.utils.image_io import read_png, to_uint8
from mlinerf_tpu_torch.utils.misc import get_schedule

ITERS = (0, 1, 150, 199, 200, 201, 400, 599, 600, 1201, 1601, 2000)  # test_torch_train_step.py's
SCHEDULES = {
    "cos_with_warmup": dict(type="cos_with_warmup", warm_up_end=200, alpha=0.05),
    "constant": dict(type="constant"),
    "linear_warmup": dict(type="linear_warmup", warmup_steps=150),
    "cosine_warmup": dict(type="cosine_warmup", warmup_steps=200),
}
DENSE = ["neural_sdf.mlp.linear_0.weight", "neural_sdf.mlp.linear_1.weight", "neural_sdf.mlp.linear_sdf.weight",
         "neural_rgb.mlp.linear_0.weight", "neural_rgb.mlp.linear_1.weight", "neural_rgb.mlp.linear_2.weight"]


# ---------------------------------------------------------------------------
# Schedules and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """Each schedule at ITERS, the horizon from ``max_iter`` as the JAX
    package's ``get_schedule(cfg, max_iter)`` takes it: float32, equal, the
    cosines within 2.4e-7 relative (numpy's and XLA's float32 cos may
    differ by an ulp)."""
    want_fn = jax_get_schedule(JaxAttrDict(SCHEDULES[name]), max_iter=2000)
    got_fn = get_schedule(AttrDict(SCHEDULES[name]), max_iter=2000)
    for it in ITERS:
        got, want = got_fn(it), np.float32(want_fn(it))
        assert np.asarray(got).dtype == np.float32, it
        np.testing.assert_allclose(got, want, rtol=2.4e-7 if "cos" in name else 0, atol=0, err_msg=str(it))


def test_trainer_lr_takes_the_config_horizon(tmp_path):
    """The trainer's LR under cosine_warmup (horizon max_iter) is the JAX
    package's at every iteration of ITERS."""
    jcfg, tcfg = configs()
    for cfg in (jcfg, tcfg):
        cfg.optim.sched = {"type": "cosine_warmup", "warmup_steps": 100}
    _, jax_lr = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter)
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path), device="cpu")
    for it in ITERS:
        np.testing.assert_allclose(ttr.lr_fn(it), np.float32(jax_lr(it)), rtol=2.4e-7, err_msg=str(it))


def _leaves(rng):
    """A bf16 table and a float32 matrix, as JAX leaves and port tensors."""
    table = jnp.asarray(rng.uniform(-1e-4, 1e-4, (4096, 8)), jnp.bfloat16)
    weight = jnp.asarray(rng.normal(0, 0.3, (64, 32)), jnp.float32)
    return {"table": table, "weight": weight}, [torch.from_numpy(np.array(table, np.float32)).to(torch.bfloat16),
                                                 torch.from_numpy(np.array(weight))]


def _grads(rng, jparams):
    g_table = rng.normal(0, 1e-3, jparams["table"].shape) * (rng.uniform(size=jparams["table"].shape) > 0.3)
    grads = {"table": jnp.asarray(g_table, jnp.bfloat16),
             "weight": jnp.asarray(rng.normal(0, 1e-2, jparams["weight"].shape), jnp.float32)}
    return grads, [torch.from_numpy(np.array(grads["table"], np.float32)).to(torch.bfloat16),
                   torch.from_numpy(np.array(grads["weight"]))]


def _assert_leaves_close(got, want, what):
    """bf16 within one bf16 ulp; float32 within 1e-6 relative (and 1e-7)."""
    want = torch.from_numpy(np.array(want, np.float32))
    if got.dtype == torch.bfloat16:
        assert torch.all((got.float() - want).abs() <= bf16_ulp(got, want)), what
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("kind, steps", [("SGD", 4), ("RAdam", 8)])
def test_optimizer_matches_optax(kind, steps):
    """The optimizer alone on the same gradients: a bf16 table and a
    float32 matrix against optax (sgd with momentum 0.9; radam), parameters
    and state. RAdam runs 8 steps: its rectified branch starts at step 6."""
    jcfg, tcfg = configs("--optim.sched.warm_up_end=2")
    for cfg in (jcfg, tcfg):
        cfg.optim.type = kind
        if kind == "SGD":
            cfg.optim.params.momentum = 0.9
    rng = np.random.default_rng(3)
    jparams, tparams = _leaves(rng)
    tx, _ = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter)
    state = tx.init(jparams)
    opt, _ = make_optimizer(tcfg.optim, tparams, max_iter=tcfg.max_iter)
    for _ in range(steps):
        jgrads, tgrads = _grads(rng, jparams)
        updates, state = tx.update(jgrads, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jparams, updates)
        opt.step(tgrads)
    for got, key in zip(tparams, ("table", "weight")):
        _assert_leaves_close(got, jparams[key], key)
    assert not torch.equal(tparams[0].float(), torch.from_numpy(np.array(_leaves(np.random.default_rng(3))[0]["table"],
                                                                          np.float32)))
    port_state = opt.state_dict()
    if kind == "SGD":
        trace = state[0].trace
        for got, key in zip(port_state["trace"], ("table", "weight")):
            assert got.dtype == tparams[("table", "weight").index(key)].dtype
            _assert_leaves_close(got, trace[key], f"trace {key}")
    else:
        adam = state[0]
        assert port_state["count"] == int(adam.count) == steps
        for name in ("mu", "nu"):
            for got, key in zip(port_state[name], ("table", "weight")):
                assert got.dtype == tparams[("table", "weight").index(key)].dtype, name
                _assert_leaves_close(got, getattr(adam, name)[key], f"{name} {key}")


def test_multisteps_matches_optax():
    """grad_accum_iter 2 (optax.MultiSteps around AdamW), float32 leaves, 4
    steps: the parameters after each step (unchanged after the first of
    each pair), the running mean, the inner state, the counters and the
    logged LR (the outer iteration's)."""
    jcfg, tcfg = configs("--optim.sched.warm_up_end=3")
    rng = np.random.default_rng(4)
    jparams = {"a": jnp.asarray(rng.normal(0, 0.3, (64, 32)), jnp.float32),
               "b": jnp.asarray(rng.normal(0, 0.3, (16,)), jnp.float32)}
    tparams = [torch.from_numpy(np.array(jparams["a"])), torch.from_numpy(np.array(jparams["b"]))]
    tx, jlr = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter, grad_accum=2)
    opt, lr = make_optimizer(tcfg.optim, tparams, max_iter=tcfg.max_iter, grad_accum=2)
    assert isinstance(opt, MultiSteps)
    state = tx.init(jparams)
    for step in range(4):
        before = [p.clone() for p in tparams]
        grads = {k: jnp.asarray(rng.normal(0, 1e-2, v.shape), jnp.float32) for k, v in jparams.items()}
        updates, state = tx.update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jparams, updates)
        opt.step([torch.from_numpy(np.array(grads[k])) for k in ("a", "b")])
        for got, key in zip(tparams, ("a", "b")):
            _assert_leaves_close(got, jparams[key], f"{key} at step {step}")
        if step % 2 == 0:
            assert all(torch.equal(p, b) for p, b in zip(tparams, before))
        for got, key in zip(opt.acc, ("a", "b")):
            _assert_leaves_close(got, state.acc_grads[key], f"acc {key}")
        assert (opt.mini_step, opt.gradient_step) == (int(state.mini_step), int(state.gradient_step))
    adam = state.inner_opt_state[0]
    assert opt.count == int(adam.count) == 2
    for key, mu, nu in zip(("a", "b"), opt.inner.mu, opt.inner.nu):
        _assert_leaves_close(mu, adam.mu[key], f"mu {key}")
        _assert_leaves_close(nu, adam.nu[key], f"nu {key}")
    for it in ITERS:
        assert np.float32(jlr(it)) == lr(it)


def test_multisteps_keeps_a_bf16_leaf():
    """optax.MultiSteps refuses its own state at the second step of a bf16
    leaf (its mean turns float32 after the first); the port keeps the mean
    in float32 and hands the inner optimizer the mean in the leaf's dtype:
    two accumulated steps equal one AdamW step on that mean."""
    jcfg, tcfg = configs("--optim.sched.warm_up_end=0")
    rng = np.random.default_rng(6)
    jparams, tparams = _leaves(rng)
    g1, t1 = _grads(rng, jparams)
    g2, t2 = _grads(rng, jparams)
    tx, _ = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter, grad_accum=2)
    state = tx.init(jparams)
    _, state = tx.update(g1, state, jparams)
    with pytest.raises(TypeError, match="bfloat16"):
        tx.update(g2, state, jparams)
    accumulated = [p.clone() for p in tparams]
    opt, _ = make_optimizer(tcfg.optim, accumulated, max_iter=tcfg.max_iter, grad_accum=2)
    opt.step(t1)
    opt.step(t2)
    direct = [p.clone() for p in tparams]
    inner, _ = make_optimizer(tcfg.optim, direct, max_iter=tcfg.max_iter)
    assert isinstance(inner, AdamW)
    inner.step([(a.float() + (b.float() - a.float()) / 2).to(a.dtype) for a, b in zip(t1, t2)])
    assert all(torch.equal(a, b) for a, b in zip(accumulated, direct))
    assert opt.inner.nu[0].dtype == torch.bfloat16 and not torch.equal(accumulated[0], tparams[0])


# ---------------------------------------------------------------------------
# The optax state through the bridge, and resuming a JAX checkpoint
# ---------------------------------------------------------------------------


def _through_checkpoint_unpickler(tree):
    """``tree`` pickled as the JAX package's checkpointer pickles it and
    read back by the port's loader (optax's classes become records)."""
    return _JaxCheckpointUnpickler(io.BytesIO(pickle.dumps(jax.device_get(tree)))).load()


@pytest.mark.parametrize("kind", ["SGD", "MultiSteps"])
def test_opt_state_from_jax(kind):
    """SGD's trace and MultiSteps' mean, counters and inner Adam state,
    carried from optax's pickled state into the port's layout (a kernel
    transposed to its torch weight) after 3 steps: equal to the port's own
    state after the same steps."""
    jcfg, tcfg = configs("--optim.sched.warm_up_end=2")
    for cfg in (jcfg, tcfg):
        if kind == "SGD":
            cfg.optim.type = "SGD"
            cfg.optim.params.momentum = 0.9
    accum = 2 if kind == "MultiSteps" else 1
    rng = np.random.default_rng(8)
    tree = {"neural_rgb": {"mlp": {"linear_0": {"kernel": jnp.asarray(rng.normal(0, 0.3, (5, 3)), jnp.float32),
                                                "bias": jnp.zeros((3,), jnp.float32)}}}}
    names = ["neural_rgb.mlp.linear_0.weight", "neural_rgb.mlp.linear_0.bias"]
    tparams = [torch.from_numpy(np.array(tree["neural_rgb"]["mlp"]["linear_0"]["kernel"]).T.copy()),
               torch.zeros(3)]
    tx, _ = jax_make_optimizer(jcfg.optim, max_iter=jcfg.max_iter, grad_accum=accum)
    opt, _ = make_optimizer(tcfg.optim, tparams, max_iter=tcfg.max_iter, grad_accum=accum)
    state = tx.init(tree)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 1e-2, x.shape), jnp.float32), tree)
        updates, state = tx.update(grads, state, tree)
        tree = jax.tree.map(lambda p, u: p + u, tree, updates)
        lin = grads["neural_rgb"]["mlp"]["linear_0"]
        opt.step([torch.from_numpy(np.array(lin["kernel"]).T.copy()), torch.from_numpy(np.array(lin["bias"]))])
    got = opt_state_from_jax(_through_checkpoint_unpickler(state), names)
    want = opt.state_dict()

    def compare(a, b, path):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-9, err_msg=f"{path}/{i}")
        else:
            assert a == b, path

    compare(got, want, kind)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A JAX package run of two steps saved with its optax state; the port
    resumes it and both take the third step on one batch."""
    tmp = tmp_path_factory.mktemp("resume")
    jcfg, tcfg = configs()
    jcfg.runtime.mesh = "none"
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp / "jax"))
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.asarray, jtr.state.params)
    kernel = np.array(params["neural_sdf"]["mlp"]["linear_0"]["kernel"])
    kernel[3:] = rng.normal(0, 0.3, kernel[3:].shape)
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"] = kernel
    arrays = TorchDataset(tcfg).as_arrays()
    batches = [injected_batch(arrays, rng, tcfg.model.render.rand_rays) for _ in range(3)]
    steps = JaxSteps(jtr)
    trainable = jax.tree.map(jnp.asarray, params)
    state = jtr.tx.init(trainable)
    for it in range(3):
        if it == 2:
            jtr.state = jtr.state.replace(params=trainable, opt_state=state, iteration=jnp.asarray(2, jnp.int32))
            jtr.save_checkpoint(iteration=2)
            jtr.checkpointer.wait()
            saved = state[0]
        grads, logged = steps.grads(trainable, None, batches[it], it)
        updates, state = jtr.tx.update(grads, state, trainable)
        trainable = jax.tree.map(lambda p, u: p + u.astype(p.dtype), trainable, updates)
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp / "port"), device="cpu")
    assert ttr.load_checkpoint(str(tmp / "jax" / "latest_checkpoint.txt"), resume=True)
    loaded = dict(iteration=ttr.current_iteration, count=ttr.optimizer.count)
    saved = {k: params_from_jax(jax.tree.map(np.asarray, getattr(saved, k))) for k in ("mu", "nu")}
    loaded["moments_equal"] = all(torch.equal(getattr(ttr.optimizer, k)[i], saved[k][n])
                                  for k in ("mu", "nu") for i, n in enumerate(ttr.trainable_names))
    info = ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batches[2].items()})
    return dict(ttr=ttr, info=info, logged=logged, loaded=loaded, state=state, lr=float(ttr.lr_fn(2)),
                params=params_from_jax(jax.tree.map(np.asarray, trainable)))


def test_resume_from_jax_checkpoint_continues_the_run(resumed):
    """The port resumes at the JAX run's iteration and Adam count, with its
    moments bit for bit; its next step's loss within 1e-5 and its
    parameters within test_torch_train_step.py's bounds of JAX's next step
    (at the same warm-up learning rate)."""
    ttr = resumed["ttr"]
    assert resumed["loaded"] == dict(iteration=2, count=2, moments_equal=True)
    np.testing.assert_allclose(float(resumed["info"]["total"]), resumed["logged"]["total"], rtol=1e-5)
    for name, p in ttr.model.state_dict().items():
        w = resumed["params"][name]
        if p.dtype == torch.bfloat16:
            diff = (p.float() - w.float()).abs()
            ulp = bf16_ulp(p, w)
            assert float((diff <= ulp).float().mean()) >= 0.99, name
            assert torch.all(diff <= ulp + 4 * resumed["lr"]), name
        else:
            np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_resume_from_jax_checkpoint_moments(resumed):
    """Adam's moments after the resumed step: count 3, float32 leaves within
    1e-3 of the leaf max, the bf16 tables' within 25%
    (test_torch_train_step.py's bounds)."""
    ttr, adam = resumed["ttr"], resumed["state"][0]
    jmu = params_from_jax(jax.tree.map(np.asarray, adam.mu))
    jnu = params_from_jax(jax.tree.map(np.asarray, adam.nu))
    assert ttr.optimizer.count == int(adam.count) == 3
    for name, mu, nu in zip(ttr.trainable_names, ttr.optimizer.mu, ttr.optimizer.nu):
        tol = 0.25 if nu.dtype == torch.bfloat16 else 1e-3
        assert_close_to_leaf_max(mu.numpy(), jmu[name].float().numpy(), tol, name)
        assert_close_to_leaf_max(nu.float().numpy(), jnu[name].float().numpy(), tol, name)


# ---------------------------------------------------------------------------
# trainer.init and the runtime keys in the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "xavier", "xavier_uniform", "kaiming", "orthogonal"])
def test_trainer_init(kind, tmp_path):
    """``trainer.init.type`` draws every dense weight anew (and nothing
    else: biases, weight-norm g, tables stay), with flax's variance: the
    64 x 64 weights' std within 10% of the scheme's (fan in 64, out 64), or
    orthonormal rows. The draws differ from JAX's."""
    _, base_cfg = configs()
    _, cfg = configs(f"--trainer.init.type={kind}", "--trainer.init.gain=1.0")
    base = TorchTrainer(base_cfg, seed=0, logdir=str(tmp_path / "base"), device="cpu").model.state_dict()
    got = TorchTrainer(cfg, seed=0, logdir=str(tmp_path / kind), device="cpu").model.state_dict()
    changed = sorted(n for n in base if not torch.equal(base[n], got[n]))
    assert changed == sorted(DENSE)
    w = got["neural_rgb.mlp.linear_1.weight"]
    if kind == "orthogonal":
        torch.testing.assert_close(w @ w.T, torch.eye(64), rtol=0, atol=1e-5)
    else:
        want = {"normal": 0.02, "xavier": (1 / 64) ** 0.5, "xavier_uniform": (1 / 64) ** 0.5,
                "kaiming": (2 / 64) ** 0.5}[kind]
        assert abs(float(w.std()) / want - 1) < 0.1, float(w.std())
    again = TorchTrainer(cfg, seed=0, logdir=str(tmp_path / "again"), device="cpu").model.state_dict()
    assert all(torch.equal(got[n], again[n]) for n in DENSE)


@pytest.mark.parametrize("extra", [["--trainer.grad_accum_iter=2"], ["--optim.type=SGD"], ["--optim.type=RAdam"]])
def test_runtime_keys_train(extra, tmp_path):
    """The keys the port refused before train: two steps from injected
    batches, finite; with grad_accum_iter 2 the first step leaves every
    parameter as it was and the second moves them."""
    _, cfg = configs("--optim.sched.warm_up_end=0", *extra)
    ttr = TorchTrainer(cfg, seed=0, logdir=str(tmp_path), device="cpu")
    with torch.no_grad():
        w = ttr.model.neural_sdf.mlp.linear_0.weight
        w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.3
    start = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    rng = np.random.default_rng(2)
    arrays = TorchDataset(cfg).as_arrays()
    for step in range(2):
        info = ttr.train_step({k: torch.from_numpy(np.array(v))
                               for k, v in injected_batch(arrays, rng, cfg.model.render.rand_rays).items()})
        assert np.isfinite(float(info["total"]))
        same = all(torch.equal(v, start[k]) for k, v in ttr.model.state_dict().items())
        assert same == (step == 0 and "--trainer.grad_accum_iter=2" in extra)


# ---------------------------------------------------------------------------
# Heatmap, logger sinks, validation images, watchdog, --profile
# ---------------------------------------------------------------------------


def test_heatmap_matches_jax():
    """``get_heatmap`` and ``preprocess_image`` bitwise the JAX package's."""
    rng = np.random.default_rng(0)
    gray = rng.uniform(-0.2, 1.2, (17, 23)).astype(np.float32)
    gray[0, :3] = [0.0, 1.0, 0.5]
    np.testing.assert_array_equal(console.get_heatmap(gray), jax_console.get_heatmap(gray))
    np.testing.assert_array_equal(console.get_heatmap(gray, cmap="gray"), jax_console.get_heatmap(gray, cmap="gray"))
    img = rng.uniform(-1, 3, (2, 9, 7, 1)).astype(np.float32)
    np.testing.assert_array_equal(console.preprocess_image(img, from_range=(-1, 3)),
                                  jax_console.preprocess_image(img, from_range=(-1, 3)))


def test_log_images_files(tmp_path):
    """Each image as <logdir>/images/<step:09d>/<key with / as _>.png; a
    single-channel map colorized by the heatmap; a disabled logger (every
    rank but 0) writes nothing."""
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 1, (8, 6, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (8, 6, 1)).astype(np.float32)
    MetricsLogger(str(tmp_path / "on")).log_images({"val/rgb_render": rgb, "val/depth": depth}, step=7)
    out = tmp_path / "on" / "images" / "000000007"
    np.testing.assert_array_equal(read_png(str(out / "val_rgb_render.png")), to_uint8(rgb))
    np.testing.assert_array_equal(read_png(str(out / "val_depth.png")), to_uint8(console.get_heatmap(depth[..., 0])))
    off = MetricsLogger(str(tmp_path / "off"), enabled=False)
    off.log_images({"val/rgb_render": rgb}, step=7)
    off.log_scalars({"x": 1.0}, 7)
    assert sorted(os.listdir(tmp_path / "off")) == []


def test_wandb_notice_and_tensorboard(tmp_path, monkeypatch, capsys):
    """Without the wandb package the logger prints the JAX package's
    notice and keeps the JSONL sink; TensorBoard writes its events where
    the package imports (else its notice)."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    logger = MetricsLogger(str(tmp_path), use_wandb=True, use_tensorboard=True)
    out = capsys.readouterr().out
    assert "[logger] wandb unavailable" in out and "falling back to JSONL only" in out and logger.wandb is None
    logger.log_scalars({"train/total_loss": 0.5}, 3)
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 1
    if logger.tb is None:
        assert "[logger] tensorboard unavailable" in out
    else:
        assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path / "tensorboard"))


def test_validation_writes_images(tmp_path):
    """A validation writes val_rgb_render, val_rgb_target and val_normal
    PNGs of the first image at the step's folder, beside val/psnr."""
    size = ["--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]", "--model.render.rand_rays_val=256"]
    _, cfg = configs(*size)
    ttr = TorchTrainer(cfg, seed=0, logdir=str(tmp_path), device="cpu")
    psnr = ttr.validate(TorchDataset(cfg, is_inference=True), step=3, max_samples=1)
    assert np.isfinite(psnr)
    out = tmp_path / "images" / "000000003"
    assert sorted(os.listdir(out)) == ["val_normal.png", "val_rgb_render.png", "val_rgb_target.png"]
    assert all(read_png(str(out / n)).shape == (16, 16, 3) for n in os.listdir(out))


def test_watchdog_fires():
    """SIGALRM after the timeout raises TimeoutError; 9999999 is off."""
    previous = signal.getsignal(signal.SIGALRM)
    try:
        dog = Watchdog(1)
        dog.reset()
        with pytest.raises(TimeoutError, match="stalled for 1s"):
            time.sleep(5)
        dog.reset()
        dog.disarm()
        time.sleep(1.5)  # disarmed: nothing fires
        assert not Watchdog(9999999).enabled
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def test_train_profile(tmp_path, capsys):
    """``train.py --profile`` for two steps: the trace under
    <logdir>/profile and its table by category, with the table-gradient
    scatter's row (on the CPU, the plain version's index_add_)."""
    logdir = tmp_path / "prof"
    train_cli.main(["--config", CONFIG, "--logdir", str(logdir), "--device", "cpu", "--profile", "--max_iter=2",
                    "--logging_iter=1", *TINY])
    out = capsys.readouterr().out
    assert (logdir / "profile" / "trace.json").exists()
    assert "== host time by category" in out
    table = out.split("== host time by category")[1]
    assert any(line.split(":")[0].strip() == "scatter" for line in table.splitlines() if ":" in line)
    assert "aten::index_add_" in table
