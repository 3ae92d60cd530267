"""Data-parallel training at several rank and ray counts, one run after
another: ``python -m mlinerf_tpu_torch.ddp_scaling RUNS [--config YAML]
[--steps N] [--logroot DIR] [--a.b=value ...]``.

``RUNS`` is a comma-separated list of ``ranks:global_rays:arm`` (``arm``:
``grad_psum`` or ``shard_tables``), e.g. ``1:1024:grad_psum,4:4096:shard_tables``.
Each run is ``python -m torch.distributed.run --nproc_per_node=<ranks> -m
mlinerf_tpu_torch.train`` on the config (default configs/syn_prodscale_a.yaml,
coarse-to-fine off, ``--runtime.<arm>=True``) for ``--steps`` steps (1
warm-up), into ``<logroot>/<ranks>_<rays>_<arm>`` (default
``logs/ddp_scaling``). Other overrides
go to every run (``--device cpu`` for gloo on the CPU). Each run prints one
``SCALING {...}`` line: the median step ms after the warm-up, rays/s over
all ranks, and per rank the median combine ms after the warm-up, its
bytes per step, peak memory, scatter launches and CUDA-graph replays (the
training CLI's ``[dist]`` lines; on NCCL every step after a graph's first
two is a replay); where ``nvidia-smi`` is, the last line is the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(ranks: int, rays: int, arm: str, config: str, steps: int, logroot: str, extra) -> dict:
    """One launcher run; returns its summary."""
    logdir = os.path.join(logroot, f"{ranks}_{rays}_{arm}")
    shutil.rmtree(logdir, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", f"--nproc_per_node={ranks}",
           "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "-m", "mlinerf_tpu_torch.train",
           "--config", config, "--logdir", logdir, f"--max_iter={steps}", "--logging_iter=1",
           f"--checkpoint.save_iter={steps}", "--model.object.sdf.encoding.coarse2fine.enabled!",
           f"--model.render.rand_rays={rays}", f"--runtime.{arm}=True", *extra]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if done.returncode != 0:
        raise RuntimeError(f"{ranks}:{rays}:{arm} exited {done.returncode}: {done.stderr[-5000:]}")
    decoder = json.JSONDecoder()
    reports = [decoder.raw_decode(part)[0] for part in done.stdout.split("[dist] ")[1:] if part.startswith("{")]
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    return dict(ranks=ranks, global_rays=rays, rays_per_rank=rays // ranks, arm=arm, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms), rays_per_s=rays / statistics.median(step_ms) * 1e3,
                combine_ms_median={r["rank"]: statistics.median(r["combine_ms"][1:]) for r in reports},
                combine_bytes={r["rank"]: r["combine_bytes_per_step"] for r in reports},
                peak_mem={r["rank"]: r["peak_mem_bytes"] for r in reports},
                launches={r["rank"]: r["scatter_launches"] for r in reports},
                graph_replays={r["rank"]: r["graph_replays"] for r in reports},
                writers=[r["rank"] for r in reports if r["writes"]], loss=[r["train/total_loss"] for r in records],
                wall_s=wall)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("runs", help="ranks:global_rays:arm[,...]")
    parser.add_argument("--config", default=os.path.join(ROOT, "configs", "syn_prodscale_a.yaml"))
    parser.add_argument("--steps", type=int, default=6, help="Steps per run, the first a warm-up.")
    parser.add_argument("--logroot", default=os.path.join(ROOT, "logs", "ddp_scaling"))
    args, extra = parser.parse_known_args(argv)
    for spec in args.runs.split(","):
        ranks, rays, arm = spec.split(":")
        summary = run(int(ranks), int(rays), arm, args.config, args.steps, args.logroot, extra)
        print("SCALING " + json.dumps(summary), flush=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
