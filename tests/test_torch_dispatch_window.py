"""The port's dispatch windows (mlinerf_tpu_torch/trainers/windows.py and
BaseTrainer.train / run_window / render_image) against the JAX package's
scanned training windows and windowed renders (trainers/base.py ``train``,
``build_train_loop``, ``render_image``), on the CPU at the TINY size:

(a) the window sequence and the logged steps equal JAX ``train()``'s, for a
    gcd cadence, an int window, ``null`` on the CPU and on a device, and
    ``auto``; (b) the logged window means equal the means of JAX's steps on
    the same injected batches; (c) a window of n steps equals n one-step
    windows bitwise, across a level-growth boundary; (d) the occupancy grid
    is refreshed at the same window starts as JAX's; (e) render windows of 1,
    4, ``auto`` and fused give the same bits, and match JAX's render; (f) each
    schedule-table row equals that step's host values bitwise.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, injected_batch, perturb_jax_params

from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.trainers import windows
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

# ---------------------------------------------------------------------------
# (a), (d): the window sequence, the logged steps, the occupancy refreshes
# ---------------------------------------------------------------------------

CADENCES = {
    # name: (overrides, device branch, parameter count seen by the default rule)
    "gcd": (["--max_iter=20", "--logging_iter=6", "--validation_iter=9", "--checkpoint.save_iter=18",
             "--checkpoint.save_latest_iter=1000", "--trainer.steps_per_dispatch=2"], False, None),
    "int": (["--max_iter=14", "--logging_iter=6", "--trainer.steps_per_dispatch=4"], False, None),
    "null_cpu": (["--max_iter=45", "--logging_iter=40"], False, None),
    "null_device": (["--max_iter=45", "--logging_iter=40"], True, None),
    "null_device_large": (["--max_iter=12", "--logging_iter=12"], True, 5e6),
    "auto": (["--max_iter=40", "--logging_iter=36", "--trainer.steps_per_dispatch=auto"], False, None),
}
OCC = ["--model.render.occupancy.enabled", "--model.render.occupancy.resolution=8",
       "--model.render.occupancy.update_every=3"]


class _RecordingJaxTrainer(JaxTrainer):
    """The JAX trainer with each occupancy refresh recorded (the iteration
    it happens at) and its train loops replaced by stubs that record the
    window and return fixed values; nothing of the package changes."""

    @property
    def _last_occupancy_grid(self):
        return self.__dict__.get("_grid")

    @_last_occupancy_grid.setter
    def _last_occupancy_grid(self, grid):
        self.__dict__.setdefault("refreshed", []).append(self.current_iteration)
        self.__dict__["_grid"] = grid


def _jax_windows(jcfg, tmp_path, device_branch, num_params, monkeypatch):
    jtr = _RecordingJaxTrainer(jcfg, seed=0, logdir=str(tmp_path / "jax"))
    if num_params is not None:
        jtr.num_params = num_params
    if device_branch:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    windows_run, logged = [], []

    def stub(n):
        def loop(state, arrays, rng):
            windows_run.append(n)
            one = jnp.float32(1.0)
            return state, dict(total=one, losses={"render": one}, metrics={"psnr": one}, grad_norm=one)
        return loop

    monkeypatch.setattr(jtr, "build_train_step", lambda: stub(1))
    monkeypatch.setattr(jtr, "build_train_loop", stub)
    log = jtr.logger.log_scalars
    monkeypatch.setattr(jtr.logger, "log_scalars", lambda s, step: (logged.append(step), log(s, step)))
    jtr.train(_arrays(jcfg))
    monkeypatch.undo()
    return windows_run, logged, jtr.__dict__.get("refreshed", [])


@functools.lru_cache(maxsize=None)
def _dataset(image_size):
    _, tcfg = configs(f"--data.train.image_size=[{image_size},{image_size}]")
    return TorchDataset(tcfg).as_arrays()


def _arrays(cfg):
    return _dataset(int(cfg.data.train.image_size[0]))


def _port_windows(tcfg, tmp_path, device_branch, num_params, monkeypatch, real_steps=False):
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / "port"), device="cpu")
    if num_params is not None:
        ttr.num_params = num_params
    if device_branch:
        rule = windows.steps_per_dispatch
        monkeypatch.setattr(windows, "steps_per_dispatch",
                            lambda cfg, c, device, n: rule(cfg, c, torch.device("cuda"), n))
    windows_run, refreshed = [], []
    run = ttr.run_window
    monkeypatch.setattr(ttr, "run_window", lambda arrays, n: (windows_run.append(n), run(arrays, n))[1])
    if not real_steps:
        def stub_step(arrays, host_cond, opt_key):
            if ttr._acc is None:
                ttr._acc_names = ["total", "loss/render", "metric/psnr", "grad_norm", "table_grad_norm"]
                ttr._acc = torch.zeros(5)
            ttr._acc.add_(1.0)
            ttr._sched_pos.add_(1)
        monkeypatch.setattr(ttr, "_window_step", stub_step)
    refresh = ttr.maybe_update_occupancy

    def recording():
        before = ttr._occupancy_iter
        refresh()
        if ttr._occupancy_iter != before:
            refreshed.append(ttr.current_iteration)

    monkeypatch.setattr(ttr, "maybe_update_occupancy", recording)
    ttr.train(_arrays(tcfg))
    monkeypatch.undo()
    logged = [json.loads(line)["step"] for line in open(tmp_path / "port" / "metrics.jsonl")]
    return windows_run, logged, refreshed


@pytest.mark.parametrize("case", sorted(CADENCES))
def test_window_sequence_matches_jax_train(case, tmp_path, monkeypatch):
    """The windows each package runs and the steps it logs, with both step
    bodies stubbed (the sizing rule is what is under test: JAX's cadence
    gcd, steps_per_dispatch int / null per backend / auto, the boundary
    rule). ``auto`` times a stub on both sides, which the cap of 32 and the
    cadence then bound."""
    overrides, device_branch, num_params = CADENCES[case]
    jcfg, tcfg = configs(*overrides, "--data.train.image_size=[16,16]")
    jw, jlog, _ = _jax_windows(jcfg, tmp_path, device_branch, num_params, monkeypatch)
    tw, tlog, _ = _port_windows(tcfg, tmp_path, device_branch, num_params, monkeypatch)
    assert tw == jw, (tw, jw)
    assert tlog == jlog, (tlog, jlog)
    assert sum(tw) == tcfg.max_iter


def test_occupancy_refreshes_at_jax_window_starts(tmp_path, monkeypatch):
    """With update_every 3 and windows of 2 (logging every 4), JAX refreshes
    the grid at the window starts 0, 4 and 8; so does the port, on real
    steps."""
    jcfg, tcfg = configs(*OCC, "--max_iter=10", "--logging_iter=4", "--trainer.steps_per_dispatch=2",
                         "--data.train.image_size=[16,16]")
    jw, _, jref = _jax_windows(jcfg, tmp_path, False, None, monkeypatch)
    tw, _, tref = _port_windows(tcfg, tmp_path, False, None, monkeypatch, real_steps=True)
    assert tw == jw == [2, 2, 2, 2, 2]
    assert tref == jref == [0, 4, 8]


# ---------------------------------------------------------------------------
# (b): the logged window means against JAX's steps
# ---------------------------------------------------------------------------


def _jax_step_values(jtr, params, opt_state, it, batch):
    """One JAX package train step (trainers/base.py ``_train_step_fn``),
    eager: the new params and state, and what its ``info`` holds."""
    import optax

    cond = dict(jtr.make_cond(jnp.asarray(it, jnp.int32)))
    cond["max_levels"] = jtr.static_max_levels_for(it)
    weights = jtr.loss_weights_at(jnp.asarray(it, jnp.int32), cond)

    def loss_fn(p):
        out = jtr.model.apply({"params": p}, batch, cond, jax.random.PRNGKey(0), train=True)
        loss_dict, metric_dict = jtr.compute_loss(out, batch, mode="train")
        total = jnp.zeros((), jnp.float32)
        for k, v in loss_dict.items():
            if k in weights:
                total = total + weights[k] * v
        return total, (loss_dict, metric_dict)

    (total, (losses, metrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, opt_state = jtr.tx.update(grads, opt_state, params)
    params = jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, updates)
    info = dict(total=total, **{f"loss/{k}": v for k, v in losses.items()},
                **{f"metric/{k}": v for k, v in metrics.items()}, grad_norm=optax.global_norm(grads))
    return params, opt_state, info


MEANS_CUT = ["--model.render.num_sample_hierarchy=0", "--model.render.rand_rays=32"]


def test_logged_window_means_match_jax(tmp_path, monkeypatch):
    """One window of 2 steps (lr(0) = 0, so both run on the same params) on
    injected batches: the port's metrics.jsonl line holds the mean of JAX's
    two steps, as ``build_train_loop`` logs it (jnp.mean over the scan).
    Tolerances: the losses and PSNR rtol 1e-5 (test_torch_train_step's loss
    bound); the gradient norm rtol 1e-4 (the JAX package's CPU path sums each
    table row's gradient in bf16, the port in float32; the bf16 tables'
    share of the norm is small)."""
    jcfg, tcfg = configs("--max_iter=2", "--logging_iter=2", "--trainer.steps_per_dispatch=2", *MEANS_CUT)
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path / "jax"))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / "port"), device="cpu")
    rng = np.random.default_rng(0)
    params = perturb_jax_params(jtr.state.params, rng)
    ttr.model.load_state_dict(params_from_jax(params))
    arrays = TorchDataset(tcfg).as_arrays()
    batches = [injected_batch(arrays, rng, tcfg.model.render.rand_rays) for _ in range(2)]
    jparams, opt_state = jax.tree.map(jnp.asarray, params), jtr.tx.init(jax.tree.map(jnp.asarray, params))
    infos = []
    for it, batch in enumerate(batches):
        jparams, opt_state, info = _jax_step_values(jtr, jparams, opt_state, it,
                                                    {k: jnp.asarray(v) for k, v in batch.items()})
        infos.append(info)
    want = {k: float(jnp.mean(jnp.stack([i[k] for i in infos]))) for k in infos[0]}
    queue = iter([{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches])
    monkeypatch.setattr(ttr, "sample_batch", lambda arrays: next(queue))
    ttr.train(arrays)
    (record,) = [json.loads(line) for line in open(tmp_path / "port" / "metrics.jsonl")]
    assert record["step"] == 2
    np.testing.assert_allclose(record["train/total_loss"], want["total"], rtol=1e-5)
    losses = sorted(k for k in want if k.startswith("loss/"))
    assert losses == sorted(k[6:] for k in record if k.startswith("train/loss/"))
    for k in losses:
        np.testing.assert_allclose(record[f"train/{k}"], want[k], rtol=1e-5, err_msg=k)
    # JAX also logs ``s_var``, output.get("s_var", 0), which no JAX model
    # outputs: always 0; the port logs PSNR alone.
    assert want["metric/s_var"] == 0.0
    np.testing.assert_allclose(record["train/psnr"], want["metric/psnr"], rtol=1e-5)
    np.testing.assert_allclose(record["train/grad_norm"], want["grad_norm"], rtol=1e-4)
    # The mean is of both steps, not the last one's value.
    assert record["train/total_loss"] != pytest.approx(float(infos[-1]["total"]), rel=1e-7)


# ---------------------------------------------------------------------------
# (c), (f): a window against one-step windows; the schedule table
# ---------------------------------------------------------------------------

GROWTH = ["--model.object.sdf.encoding.coarse2fine.init_active_level=2", "--data.train.image_size=[16,16]"]
START = 798  # active levels 2 -> 3 at iteration 800


def _trainer_at(tcfg, tmp_path, name, start):
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path / name), device="cpu")
    with torch.no_grad():  # open the encoder's columns, so the tables see gradient
        w = ttr.model.neural_sdf.mlp.linear_0.weight
        w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.3
    ttr.current_iteration = start
    ttr.optimizer.advance(start)
    return ttr


@pytest.mark.parametrize("optim", ["adamw", "radam_accum2"])
def test_window_equals_single_steps_bitwise(optim, tmp_path):
    """A window of 4 steps (798-801, across the growth of the live levels
    from 2 to 3 at 800, so all 4 take the level cap 3) against 4 one-step
    windows (cap 2, 2, 3, 3): parameters, moments and the generator's state
    bitwise equal (the cap only adds levels the mask zeroes), as JAX's
    static level truncation is exact. ``radam_accum2``: RAdam (whose
    rectification switches on at its 6th update) under grad_accum_iter 2,
    the accumulation phases and the inner schedule planned per step."""
    extra = ["--optim.type=RAdam", "--trainer.grad_accum_iter=2"] if optim != "adamw" else []
    _, tcfg = configs(*GROWTH, *extra)
    arrays = {k: torch.from_numpy(v) for k, v in _arrays(tcfg).items()}
    start = 2 if optim != "adamw" else START
    a, b = _trainer_at(tcfg, tmp_path, "a", start), _trainer_at(tcfg, tmp_path, "b", start)
    if optim == "adamw":
        assert [a.static_max_levels_for(it) for it in range(START, START + 4)] == [2, 2, 3, 3]
    rows = []
    a.run_window(arrays, 4)
    for _ in range(4):
        b.run_window(arrays, 1)
        rows.append(b._sched[0].clone())
    assert a.current_iteration == b.current_iteration == start + 4
    for (name, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    flat = lambda s: [t for v in s.values() for t in (flat(v) if isinstance(v, dict) else
                                                      v if isinstance(v, list) else [v])]
    for x, y in zip(flat(sa), flat(sb)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    # (f) each row of the window's table is that step's one-step row
    assert torch.equal(a._sched[:4].view(torch.int32), torch.stack(rows).view(torch.int32))  # NaN r too


def test_schedule_rows_are_the_host_values(tmp_path):
    """Each row of a window's schedule table holds, bitwise, what the eager
    step computes on the host at that step: progress and the NeuS anneal
    from make_cond, every loss weight (the curvature weight decays at the
    anneal boundary 800), the step size lr(count) and AdamW's bias
    corrections of count + 1 (the second per moment dtype, rounded to it)."""
    _, tcfg = configs(*GROWTH)
    arrays = {k: torch.from_numpy(v) for k, v in _arrays(tcfg).items()}
    ttr = _trainer_at(tcfg, tmp_path, "t", START)
    ttr.run_window(arrays, 4)
    table = dict(zip(ttr._sched_columns, ttr._sched[:4].T.tolist()))
    opt = ttr.optimizer
    for j, it in enumerate(range(START, START + 4)):
        cond = ttr.make_cond(it)
        assert table["progress"][j] == np.float32(it) / np.float32(tcfg.max_iter)
        assert (table["cos_anneal.0"][j], table["cos_anneal.1"][j]) == cond["cos_anneal"]
        for k, w in ttr.loss_weights_at(it, cond).items():
            assert table[f"w.{k}"][j] == w, (k, it)
        assert table["opt.lr"][j] == float(-ttr.lr_fn(it))
        assert table["opt.bc1"][j] == float(np.float32(1.0 - opt.b1 ** (it + 1)))
        bc2 = float(np.float32(1.0 - opt.b2 ** (it + 1)))
        assert table["opt.bc2.torch.float32"][j] == bc2
        assert table["opt.bc2.torch.bfloat16"][j] == torch.tensor(bc2).to(torch.bfloat16).item()
    assert table["w.curvature"][1] != table["w.curvature"][2]


# ---------------------------------------------------------------------------
# (e): render windows
# ---------------------------------------------------------------------------

RENDER_SIZE = 16
RENDER_CHUNK = 48  # 256 rays: 6 chunks, the last padded by 32


@pytest.fixture(scope="module")
def render_pair(tmp_path_factory):
    jcfg, tcfg = configs(f"--data.val.image_size=[{RENDER_SIZE},{RENDER_SIZE}]")
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax")), is_inference=True)
    params = perturb_jax_params(jtr.state.params, np.random.default_rng(4))
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("port")), device="cpu", is_inference=True)
    ttr.model.load_state_dict(params_from_jax(params))
    sample = TorchDataset(tcfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
    return jtr, ttr, data


def test_render_windows_are_bitwise_equal(render_pair):
    """Windows of 1 and 4 chunks, ``auto`` (32 here) and fused: the same
    bits, as every chunk renders at one shape."""
    _, ttr, data = render_pair
    outs = {}
    for name, fused, window in (("fused", True, "auto"), ("1", False, 1), ("4", False, 4), ("auto", False, "auto")):
        ttr.cfg.runtime.fused_inference = fused
        ttr.cfg.runtime.inference_chunks_per_dispatch = window
        outs[name] = ttr.render_image(data, (RENDER_SIZE, RENDER_SIZE), num_rays_chunk=RENDER_CHUNK)
    ttr.cfg.runtime.fused_inference = None
    ttr.cfg.runtime.inference_chunks_per_dispatch = "auto"
    for name, out in outs.items():
        assert sorted(out) == sorted(outs["fused"])
        for k, v in out.items():
            assert v.shape[1] == RENDER_SIZE * RENDER_SIZE
            np.testing.assert_array_equal(v, outs["fused"][k], err_msg=f"{name}/{k}")


def test_render_window_matches_jax_render(render_pair):
    """The port's windowed render against JAX ``render_image`` (fused on the
    CPU) from the same params: within 1e-4, the render-parity bound of
    test_torch_inference.py."""
    jtr, ttr, data = render_pair
    ttr.cfg.runtime.inference_chunks_per_dispatch = 4
    ttr.cfg.runtime.fused_inference = False
    got = ttr.render_image(data, (RENDER_SIZE, RENDER_SIZE), num_rays_chunk=RENDER_CHUNK)
    ttr.cfg.runtime.fused_inference = None
    ttr.cfg.runtime.inference_chunks_per_dispatch = "auto"
    want = jtr.render_image(data, (RENDER_SIZE, RENDER_SIZE), num_rays_chunk=RENDER_CHUNK)
    for k in ("rgb", "opacity", "depth", "gradient"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)


def test_inference_window_rule():
    """``_inference_window``'s rule: a forced int; ``auto`` gives 1 above
    4,096 rays, 4 after training in this process, 4 for heavy configs
    (dict 2^20, or more than 96 samples), else 32."""
    _, tcfg = configs()
    assert windows.inference_window(tcfg, 4096, False) == 32
    assert windows.inference_window(tcfg, 4097, False) == 1
    assert windows.inference_window(tcfg, 4096, True) == 4
    _, heavy = configs("--model.object.sdf.encoding.hashgrid.dict_size=20")
    assert windows.inference_window(heavy, 1024, False) == 4
    _, deep = configs("--model.render.num_samples.coarse=80", "--model.render.num_samples.fine=17")
    assert windows.inference_window(deep, 1024, False) == 4
    tcfg.runtime.inference_chunks_per_dispatch = 7
    assert windows.inference_window(tcfg, 8192, True) == 7
    assert windows.fused_inference(tcfg, torch.device("cpu")) and not windows.fused_inference(
        tcfg, torch.device("cuda"))
