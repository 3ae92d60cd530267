"""The port's CLIs under torch's launcher on the CPU: ``python -m
torch.distributed.run --nproc_per_node 2 -m mlinerf_tpu_torch.train
--device cpu`` on the TINY config (gloo), against the same run in one
process, then ``--resume`` on two ranks and the inference CLI on two
ranks."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import CONFIG, tiny_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def _free_port() -> str:
    """An OS-assigned free TCP port (tests/test_multihost.py's)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return str(port)


def _launch(module, *args, ranks=2):
    """Run a CLI under the launcher (``ranks`` processes) or, with ranks 0,
    as one plain process; returns its stdout. Every rank must exit 0."""
    launcher = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", f"--nproc_per_node={ranks}",
                "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "-m"] if ranks else [sys.executable, "-m"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(launcher + [module, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout


def _reports(stdout):
    """The ``[dist]`` lines, by rank."""
    decoder = json.JSONDecoder()
    reports = [decoder.raw_decode(part)[0] for part in stdout.split("[dist] ")[1:] if part.startswith("{")]
    return {r["rank"]: r for r in reports}


def _metrics(logdir):
    return [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    train = lambda logdir, *extra, ranks=2: _launch(  # noqa: E731
        "mlinerf_tpu_torch.train", "--config", CONFIG, "--logdir", str(logdir), "--device", "cpu",
        "--logging_iter=1", *tiny_args(*extra), ranks=ranks)
    two = train(tmp / "two", f"--max_iter={STEPS}")
    one = train(tmp / "one", f"--max_iter={STEPS}", ranks=0)
    two_metrics = _metrics(tmp / "two")
    resumed = _launch("mlinerf_tpu_torch.train", "--config", CONFIG, "--logdir", str(tmp / "two"), "--device", "cpu",
                      "--resume", "--logging_iter=1", *tiny_args(f"--max_iter={2 * STEPS}"))
    test = _launch("mlinerf_tpu_torch.test", "--config", CONFIG, "--logdir", str(tmp / "two"), "--device", "cpu",
                   "--inference_mode", "image_test", *tiny_args("--data.val.subset=1"))
    return dict(tmp=tmp, two=two, one=one, two_metrics=two_metrics, resumed=resumed, test=test)


def test_ranks_log_the_same_loss(runs):
    """Both ranks log the same mean loss (the ranks' mean, on every rank)
    and report their combine."""
    reports = _reports(runs["two"])
    assert sorted(reports) == [0, 1] and all(r["world"] == 2 for r in reports.values())
    assert reports[0]["last_loss"] == reports[1]["last_loss"]
    assert all(r["combine_bytes_per_step"] > 0 and len(r["combine_ms"]) == STEPS for r in reports.values())


def test_window_line_says_gloo_steps_are_eager(runs):
    """Each gloo rank says that its windows run as eager steps and why (its
    collectives run on the host, which no CUDA graph captures), and
    replays nothing."""
    line = ("[window] 2 ranks (gloo, cpu): windows of up to 1 steps run as eager steps (gloo runs its collectives "
            "on the host, which a CUDA graph cannot capture)")
    assert runs["two"].count(line) == 2, [w for w in runs["two"].splitlines() if w.startswith("[window]")]
    assert all(r["graph_replays"] == 0 for r in _reports(runs["two"]).values())


def test_two_ranks_match_one_process(runs):
    """The two-rank run's logged losses within 1e-4 of one process's
    (test_multihost.py's bound): the same global batches, split."""
    one = _metrics(runs["tmp"] / "one")
    two = runs["two_metrics"]
    assert [r["step"] for r in one] == [r["step"] for r in two] == list(range(1, STEPS + 1))
    for a, b in zip(one, two):
        np.testing.assert_allclose(b["train/total_loss"], a["train/total_loss"], rtol=1e-4)
        assert "dist/combine_ms" in b and "dist/combine_ms" not in a


def test_rank_zero_alone_writes(runs):
    """One line per logged step in metrics.jsonl (not one per rank), one
    checkpoint chain, and only rank 0 reports writing."""
    reports = _reports(runs["two"])
    assert reports[0]["writes"] is True and reports[1]["writes"] is False
    assert [r["step"] for r in runs["two_metrics"]] == list(range(1, STEPS + 1))
    logdir = runs["tmp"] / "two"
    assert (logdir / "latest_checkpoint.txt").exists() and (logdir / "config.yaml").exists()


def test_resume_continues_on_two_ranks(runs):
    """``--resume`` on two ranks takes the checkpoint's iteration and goes
    on to max_iter: the steps after it append to metrics.jsonl."""
    steps = [r["step"] for r in _metrics(runs["tmp"] / "two")]
    assert steps == list(range(1, 2 * STEPS + 1))
    assert f"(iteration {STEPS})" in runs["resumed"]
    reports = _reports(runs["resumed"])
    assert reports[0]["last_loss"] == reports[1]["last_loss"]


def test_inference_cli_on_two_ranks_writes_once(runs):
    """Rank 0 renders and writes; rank 1 waits at the barrier and writes
    nothing."""
    out_dir = runs["tmp"] / "two" / "output_image"
    assert (out_dir / "0_rgb_map.png").exists()
    assert runs["test"].count("Outputs written to") == 1


def test_ddp_scaling_cli(tmp_path):
    """``python -m mlinerf_tpu_torch.ddp_scaling`` on two gloo ranks: one
    SCALING line with the run's step, combine and writers."""
    out = _launch("mlinerf_tpu_torch.ddp_scaling", "2:64:grad_psum", "--steps=2", f"--logroot={tmp_path}",
                  "--device", "cpu",
                  *[a for a in tiny_args() if not a.startswith("--model.render.rand_rays=")], ranks=0)
    lines = [json.loads(line.split("SCALING ", 1)[1]) for line in out.splitlines() if line.startswith("SCALING ")]
    assert len(lines) == 1 and lines[0]["ranks"] == 2 and lines[0]["rays_per_rank"] == 32
    assert lines[0]["writers"] == [0] and len(lines[0]["step_ms"]) == 1 and lines[0]["combine_bytes"]["1"] > 0
