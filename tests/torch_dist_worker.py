"""Ranks of the port's multi-rank tests (tests/test_torch_distributed.py):
``Ranks`` starts ``world`` processes (the ``spawn`` start method), each
joins a gloo group through a FileStore in the test's temporary directory
and runs one function of this module; the results come back through
``torch.save`` files. This module imports nothing of JAX, so the ranks do
not pay for it."""

from __future__ import annotations

import contextlib
import io
import multiprocessing
import os
import traceback

import numpy as np
import torch


def _rank_main(rank, world, workdir, fn_name, payload):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    try:
        result = globals()[fn_name](rank, world, workdir, payload)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` running ranks of ``fn_name``; ``join`` waits for them,
    fails unless every rank exits 0, and returns their results."""

    def __init__(self, world, workdir, fn_name, payload):
        os.makedirs(workdir, exist_ok=True)
        self.world, self.workdir = world, workdir
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(r, world, workdir, fn_name, payload)) for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self, timeout=240):
        for p in self.procs:
            p.join(timeout)
        alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = {r: open(os.path.join(self.workdir, f"rank{r}.err")).read()
                  for r in range(self.world) if os.path.exists(os.path.join(self.workdir, f"rank{r}.err"))}
        codes = [p.exitcode for p in self.procs]
        assert not alive and codes == [0] * self.world, f"ranks alive {alive}, exit codes {codes}: {errors}"
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False) for r in range(self.world)]


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def make_trainer(config, args, logdir, state=None, runtime=None):
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(config, cli_args=args)
    for key, value in (runtime or {}).items():
        cfg.runtime[key] = value
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=logdir, device="cpu")
    if state is not None:
        trainer.model.load_state_dict(state)
        if trainer.ema_model is not None:
            trainer.ema_model.load_state_dict(state)
    return trainer


def run_steps(trainer, batches):
    """``trainer.train_step`` on each global batch; returns the per-step
    logged means (total and losses, across the ranks where there are
    several)."""
    logged = []
    for batch in batches:
        info = trainer.train_step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        losses = info["losses"]
        values = torch.stack([info["total"], *losses.values()])
        if trainer.dp is not None:
            values, _ = trainer.dp.reduce_info(values, info["grad_sq"])
        logged.append(dict(zip(["total", *losses], values.tolist())))
    return logged


def run_window(trainer, batches):
    """One window of ``len(batches)`` steps through ``trainer.run_window``,
    each step on the next injected global batch (``sample_batch``
    replaced); returns the window's means."""
    queue = [{k: torch.from_numpy(np.array(v)) for k, v in batch.items()} for batch in batches]
    trainer.sample_batch = lambda arrays: queue.pop(0)
    return trainer.window_means(trainer.run_window(None, len(batches)))


def full_opt_state(trainer):
    """The optimizer state with every sharded leaf gathered whole."""
    state = trainer.optimizer.state_dict()
    if trainer.dp is not None and trainer.dp.shards:
        state = trainer._sharded_state(state, trainer.dp.gather_leaf)
    return state


def train_cases(rank, world, workdir, payload):
    """Each case of ``payload["cases"]``: a trainer from its config, args,
    runtime keys and state, run over the global batches (one step each, or
    with ``"window"`` one window of them through ``run_window``); its logged
    means (a window's: its means), parameters, optimizer state and layout."""
    out = {}
    for case in payload["cases"]:
        trainer = make_trainer(case["config"], case["args"], os.path.join(workdir, case["name"], str(rank)),
                               state=case.get("state"), runtime=case.get("runtime"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            logged = (run_window if case.get("window") else run_steps)(trainer, case["batches"])
        out[case["name"]] = dict(
            logged=logged, params={k: v.clone() for k, v in trainer.model.state_dict().items()},
            opt_state=full_opt_state(trainer), grad_psum=trainer.grad_psum, world=trainer.world,
            global_layout=trainer.dp.global_layout if trainer.dp is not None else None,
            sharded=sorted(trainer.trainable_names[i] for i in (trainer.dp.shards if trainer.dp else {})),
            moment_rows={trainer.trainable_names[i]: int(trainer.optimizer.mu[i].shape[0])
                         for i in (trainer.dp.shards if trainer.dp else {})},
            stdout=buf.getvalue(), graph_steps=trainer.graph_steps)
    return out


def policy(rank, world, workdir, payload):
    """The ``grad_psum`` policy on a real group: what each runtime setting
    resolves to, or the error it raises."""
    out = {}
    for name, runtime in payload["cases"].items():
        try:
            trainer = make_trainer(payload["config"], payload["args"], os.path.join(workdir, name, str(rank)),
                                   runtime=runtime)
            out[name] = dict(grad_psum=trainer.grad_psum, world=trainer.world, dp=trainer.dp is not None)
        except ValueError as exc:
            out[name] = dict(error=str(exc))
    return out


def capture_cases(rank, world, workdir, payload):
    """Each case of ``payload``: a trainer on the config's own dataset, one
    window of one step (the warm-up: caches fill there), then one more with
    its step body watched (``torch_parity.watch_host_reads``); the host
    reads and host-data tensors found there."""
    from torch_parity import watch_host_reads

    from mlinerf_tpu_torch.config import resolve

    out = {}
    for case in payload["cases"]:
        trainer = make_trainer(case["config"], case["args"], os.path.join(workdir, "capture", case["name"], str(rank)),
                               state=case.get("state"), runtime=case.get("runtime"))
        arrays = {k: torch.as_tensor(np.asarray(v))
                  for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.run_window(arrays, 1)
            reads, made = watch_host_reads(trainer)
            trainer.run_window(arrays, 1)
        out[case["name"]] = dict(reads=reads, made=made, gathers_rays=trainer.dp.global_layout,
                                 sharded=len(trainer.dp.shards))
    return out


def auto_window(rank, world, workdir, payload):
    """``trainer.train`` with ``trainer.steps_per_dispatch: auto`` on the
    config's own dataset; the lines it printed."""
    from mlinerf_tpu_torch.config import resolve

    trainer = make_trainer(payload["config"], payload["args"], os.path.join(workdir, "auto", str(rank)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer.train(resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays())
    return buf.getvalue().splitlines()


def suite(rank, world, workdir, payload):
    """``train_cases``, then ``policy`` (under ``"policy"``),
    ``capture_cases`` (under ``"capture"``) and ``auto_window`` (under
    ``"auto"``)."""
    out = train_cases(rank, world, workdir, payload)
    out["policy"] = policy(rank, world, workdir, payload["policy"])
    out["capture"] = capture_cases(rank, world, workdir, payload["capture"])
    out["auto"] = auto_window(rank, world, workdir, payload["auto"])
    return out
