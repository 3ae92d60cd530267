#!/usr/bin/env python3
"""Quality and full-width measurements of the PyTorch port
(mlinerf_tpu_torch) on one NVIDIA GPU, against the JAX package's TPU run of
the same configs. Run from the root of a checkout on a machine with a CUDA
card (about 15 minutes on an H100):

    python3 chip_quality.py [--out DIR]

Phases, each printing one JSON line:
  env      torch/CUDA versions, the card's name and power limit; TF32 off.
  quality  ``python -m mlinerf_tpu_torch.run_synthetic --conf_a
           configs/syn_e2e_a.yaml --conf_b configs/syn_e2e_b.yaml`` in
           process at the configs' own 2,000 + 1,000 steps (train-a,
           ``unpairlights_train``, pseudo labels, train-b, ``image_test``,
           metrics): each step's wall seconds, ms per training step, the
           stage-a training PSNR at its last step, stage b's rgb, ref and
           sha PSNR and SSIM; each PSNR beside the JAX package's TPU run
           (docs/round5_evidence/e2e: metrics.json and pipeline.log) and
           whether it lies within BAND_DB of it.
  probe    ``pipelines.indirect_light.indirect_light_probe`` at full width
           on the stage-a checkpoint: the first validation view at
           256x256 with the defaults (resolution 300, grid fraction 0.3:
           3 x 3 probed pixels, 810,000 secondary rays); seconds, peak
           memory, 0 scatter launches; the mosaic written as a PNG under
           --out.
  bench    ``python -m mlinerf_tpu_torch.bench`` at its default config and
           with BENCH_CONFIG=reference, each in a process of its own: the
           JSON line each prints.
Then the card line from nvidia-smi. Exits non-zero if a phase fails; a
PSNR outside the band is reported, not a failure.

    python3 chip_quality.py --arms seed1,bf16_mlps

runs the same pipeline once per named arm instead, all arms at once on the
one card, each in a process of its own, and prints one ``arm`` line each
with the quality line's fields: ``seed1`` to ``seed4`` train both stages
from that seed (the spread of the port's own runs), ``bf16_mlps`` with
``--trainer.amp_config.enabled`` (bf16 products with float32 accumulation,
as the TPU's default matmul precision computes the JAX run's float32 MLPs).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONF_A = os.path.join(HERE, "configs", "syn_e2e_a.yaml")
CONF_B = os.path.join(HERE, "configs", "syn_e2e_b.yaml")
JAX_RUN = os.path.join(HERE, "docs", "round5_evidence", "e2e")
BAND_DB = 1.0  # the ray picks and jitter differ (torch against threefry)
PROBE_SIZE = 256
# The pipeline again from another training seed (the spread of the port's
# own runs), or with bf16 MLPs.
ARMS = {**{f"seed{n}": ["--seed", str(n)] for n in range(1, 5)}, "bf16_mlps": ["--trainer.amp_config.enabled"]}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def phase_env():
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), card=card)
    return card


def _jax_reference():
    """The JAX package's TPU run: stage b's scores and stage a's last
    logged step (the first ``[iter 2000/2000]`` line): its training PSNR,
    eikonal and curvature losses."""
    scores = json.load(open(os.path.join(JAX_RUN, "metrics.json")))
    for line in open(os.path.join(JAX_RUN, "pipeline.log")):
        if line.startswith("[iter 2000/2000]"):
            last = {k: float(re.search(rf" {k}=([0-9.]+)", line).group(1)) for k in ("psnr", "eikonal", "curvature")}
            return scores, last
    raise AssertionError("quality: no stage-a line in the JAX run's pipeline.log")


def _train_records(logdir):
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    return [r for r in records if "train/psnr" in r]


def _summary(result, logroot):
    """The fields of a quality line from run_synthetic's result: each
    stage's training records, the scores, and each PSNR (and stage a's
    eikonal and curvature losses) beside the JAX TPU run's."""
    import math

    jax_scores, jax_a = _jax_reference()
    dirs = {s: os.path.join(logroot, os.path.splitext(os.path.basename(c))[0]) for s, c in (("a", CONF_A),
                                                                                         ("b", CONF_B))}
    records = {s: _train_records(d) for s, d in dirs.items()}
    check(all(records.values()), "quality: a stage logged no training step")
    stages = {s: dict(last_step=r[-1]["step"], train_psnr=r[-1]["train/psnr"],
                      train_psnr_by_step={str(x["step"]): x["train/psnr"] for x in r},
                      ms_per_step_by_window={str(x["step"]): 1e3 * x["train/iter_time"] for x in r})
              for s, r in records.items()}
    scores = result["scores"]
    rows = {"stage_a_train_psnr": (stages["a"]["train_psnr"], jax_a["psnr"])}
    for comp in ("rgb", "ref", "sha"):
        rows[f"{comp}_psnr"] = (scores[comp]["psnr"], jax_scores[comp]["psnr"])
    check(all(math.isfinite(got) for got, _ in rows.values()), f"quality: a non-finite score {rows}")
    against = {k: dict(port=got, jax_tpu=want, diff_db=got - want, within_band=abs(got - want) <= BAND_DB)
               for k, (got, want) in rows.items()}
    last_a = records["a"][-1]
    stage_a_losses = {k: dict(port=last_a[f"train/loss/{k}"], jax_tpu=jax_a[k]) for k in ("eikonal", "curvature")}
    return dict(seed=result.get("seed", 0), overrides=result["overrides"], step_seconds=result["seconds"],
                stages=stages, scores={c: scores[c] for c in ("rgb", "ref", "sha")},
                jax_tpu_ssim={c: jax_scores[c]["ssim"] for c in ("rgb", "ref", "sha")},
                stage_a_last_losses=stage_a_losses, band_db=BAND_DB, against_jax_tpu=against,
                all_within_band=all(r["within_band"] for r in against.values()))


def phase_quality(logroot):
    from mlinerf_tpu_torch import run_synthetic

    result = run_synthetic.main(["--conf_a", CONF_A, "--conf_b", CONF_B, "--logroot", logroot])
    emit("quality", conf_a=os.path.relpath(CONF_A, HERE), conf_b=os.path.relpath(CONF_B, HERE),
         **_summary(result, logroot))
    return os.path.join(logroot, os.path.splitext(os.path.basename(CONF_A))[0])


def phase_arms(names, logroot):
    """The pipeline once per arm of ARMS, every arm at once on the card,
    each in a process of its own under ``<logroot>_<arm>``: one ``arm``
    line each."""
    runs = {}
    for name in names:
        root = f"{logroot}_{name}"
        os.makedirs(root, exist_ok=True)
        log = open(os.path.join(root, "run.log"), "w")
        cmd = [sys.executable, "-m", "mlinerf_tpu_torch.run_synthetic", "--conf_a", CONF_A, "--conf_b", CONF_B,
               "--logroot", root, *ARMS[name]]
        runs[name] = (root, log, time.perf_counter(), subprocess.Popen(cmd, cwd=HERE, stdout=log,
                                                                        stderr=subprocess.STDOUT))
    for name, (root, log, t0, proc) in runs.items():
        rc = proc.wait()
        log.close()
        wall = time.perf_counter() - t0
        check(rc == 0, f"arm {name}: exit {rc}\n{open(log.name).read()[-3000:]}")
        result = json.load(open(os.path.join(root, "syn_e2e_b", "run_synthetic.json")))
        emit("arm", arm=name, args=ARMS[name], concurrent_with=[n for n in names if n != name], wall_s=wall,
             **_summary(result, root))


def phase_probe(logdir_a, out_dir):
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.pipelines.indirect_light import indirect_light_probe
    from mlinerf_tpu_torch.utils.image_io import save_image

    size = f"[{PROBE_SIZE},{PROBE_SIZE}]"
    cfg = Config(CONF_A, cli_args=[f"--data.val.image_size={size}"])
    trainer = resolve("trainer", cfg.trainer.type)(cfg, is_inference=True, seed=0, logdir=logdir_a, device="cuda")
    check(trainer.load_checkpoint(os.path.join(logdir_a, "latest_checkpoint.txt")), "probe: no stage-a checkpoint")
    sample = resolve("dataset", cfg.data.type)(cfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if k in ("pose", "intr", "pose_light")}
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    out = indirect_light_probe(trainer, data, (PROBE_SIZE, PROBE_SIZE))
    seconds = time.perf_counter() - t0
    launches = hashgrid_scatter.launches
    mosaic = out["indirect_rgb"]
    grid = (len(out["grid_rows"]), len(out["grid_cols"]))
    check(launches == 0, f"probe: {launches} scatter launches")
    check(grid == (3, 3) and mosaic.shape == (900, 900, 3), f"probe: grid {grid}, mosaic {mosaic.shape}")
    check(bool(np.isfinite(mosaic).all()), "probe: non-finite mosaic")
    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "indirect_probe_mosaic.png")
    save_image(png, mosaic)
    save_image(os.path.join(out_dir, "indirect_probe_view.png"), out["rgb_map"][0])
    rays = 300**2 * grid[0] * grid[1]
    emit("probe", checkpoint=os.path.relpath(os.path.join(logdir_a, "latest_checkpoint.txt"), HERE),
         iteration=trainer.current_iteration, view=[PROBE_SIZE, PROBE_SIZE], probe_resolution=300, grid_fraction=0.3,
         grid=[out["grid_rows"], out["grid_cols"]], secondary_rays=rays, chunk_rays=trainer.num_val_rays(),
         seconds=seconds, secondary_rays_per_s=rays / seconds, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         held_before_bytes=held_before,
         scatter_launches=launches, mosaic_png=os.path.relpath(png, HERE), mosaic_mean=float(mosaic.mean()))


def phase_bench():
    lines = {}
    for name in ("composedautoslev4blk", "reference"):
        env = dict(os.environ, BENCH_CONFIG=name)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "mlinerf_tpu_torch.bench"], cwd=HERE, env=env,
                             capture_output=True, text=True, timeout=1800)
        check(run.returncode == 0, f"bench {name}: exit {run.returncode}\n{run.stderr[-3000:]}")
        lines[name] = dict(json.loads(run.stdout.strip().splitlines()[-1]), wall_s=time.perf_counter() - t0)
    emit("bench", lines=lines)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(HERE, "logs", "chip_quality_out"),
                        help="where the probe's PNGs go")
    parser.add_argument("--logroot", default=os.path.join(HERE, "logs", "chip_quality"))
    parser.add_argument("--arms", default="", help=f"comma-separated arms of {sorted(ARMS)} to run instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_quality: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    card = phase_env()
    if args.arms:
        names = args.arms.split(",")
        check(set(names) <= set(ARMS), f"unknown arms {sorted(set(names) - set(ARMS))}")
        phase_arms(names, args.logroot)
    else:
        logdir_a = phase_quality(args.logroot)
        phase_probe(logdir_a, args.out)
        phase_bench()
    print(card)


if __name__ == "__main__":
    main()
