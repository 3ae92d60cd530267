#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mlinerf_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of two
                                     # train steps, one image's render and two
                                     # stage-b steps

Phases, each printing one JSON line:
  env      torch/CUDA versions, the card's name and power limit; TF32 off.
  build    nvcc builds every kernel under mlinerf_tpu_torch/csrc (in parallel);
           registers and spills.
  kernel   each kernel against its plain PyTorch version: uniform-random rows
           at the training path's shapes (with device timings: cuda_ms),
           then the hard cases of the scatter (one row repeated, runs across
           warp boundaries, runs of dropped rows, N not a multiple of 32,
           F = 2, 8, 16, f32 and bf16 vals), then a bf16 table through TakeRows.
  parity   the TINY model on the card against the same model on the CPU.
  render_parity
           the TINY model with light visibility on: one 32x32
           render_image_light on the card against the same weights on the
           CPU (continuous maps within 1e-4; the boolean maps by the count
           of pixels that differ, at most 1%).
  train    stage-a training of configs/syn_prodscale_a.yaml at full width
           (coarse-to-fine off, so all 16 hash levels are live) through
           Config -> Dataset -> Trainer.train: 1 warm-up + 5 measured steps,
           the last of which saves a checkpoint; checks a finite loss, 32
           scatter-add launches per step and non-zero table gradients.
  replay   one more train step with every scatter_add_rows call recorded;
           each of its 32 launches is replayed through the kernel, the plain
           version and index_add_, giving a per-launch line and a per-step
           ``kernel`` line (sums of ms, plain_ms, library_ms, bound_ms).
  render   ``python -m mlinerf_tpu_torch.test --inference_mode
           unpairlights_train`` at full width (128x128 images, see
           RENDER_SIZE), in process: loads the train phase's checkpoint
           (iteration 6) and renders 4 frames x 4 lights with light
           visibility; checks results_all.npz and that the render launched
           no scatter-add. Prints images, rays, rays/s, ms per image and
           peak memory; with --profile, the kernel rows and the layer times
           of one more image.
  pseudo_label_parity
           the port's pseudo-label pipeline on the card against the same
           pipeline on the CPU, on the render phase's results_all with the
           same first k-means centres: shading and certainty within 1e-5,
           the k-means labels and the fill's picks by the share of pixels
           that differ (at most 1%), the reflectance by the share of pixels
           off by more than 1e-4 x max(1, |value|) (at most 1%).
  pseudo_label
           ``python -m mlinerf_tpu_torch.pipelines.pseudo_label --setting
           unpair`` in process on that render: checks pseudo_label_all.npz
           (4 cameras, 4 lights each); prints seconds per camera split into
           k-means, morphology and fill, peak memory, and the fill alone at
           the config's 256x256 on features made from a seed.
  stage_b_parity
           the TINY stage-b model (rgb_r_s) one step on the card against the
           same weights and batch on the CPU: the five losses, the updated
           radiance heads, and every other parameter bitwise unchanged.
  train_b  ``python -m mlinerf_tpu_torch.train --config
           configs/syn_prodscale_b.yaml`` in process, at full width, warm-
           started from the train phase's checkpoint and reading the
           pseudo_label phase's npz (128x128, as rendered): 1 warm-up + 5
           measured steps; checks finite losses, the SDF bitwise stage a's,
           moved heads, the warm-start report and 0 scatter-add launches.
           With --profile, the kernel rows of two more stage-b steps.
  metrics  ``python -m mlinerf_tpu_torch.test --inference_mode image_test``
           of the train_b checkpoint (2 validation images at 128x128), then
           ``python -m mlinerf_tpu_torch.pipelines.metrics --components
           rgb,ref,sha --allow_missing_lpips`` on it, both in process: each
           component's PSNR, SSIM and MSE and the seconds per image. These
           are 6-step models: the numbers show that the path runs, not a
           quality.
  metrics_parity
           PSNR, SSIM and MSE of those PNGs on the card against the CPU
           (float64, within 1e-10), and LPIPS on AlexNet weights made from a
           seed in a temporary npz (within 1e-5).
  mesh     ``python -m mlinerf_tpu_torch.extract_mesh --resolution 512
           --block_res 128 --textured`` in process on the train phase's
           checkpoint (full width); the resolution is cut from the
           reference's usual 2048 for the run's time limit. Prints SDF
           points/s and the seconds of the SDF, the marching, weld/filter,
           the texture and the PLY write, the mesh's size and peak memory;
           checks a non-empty mesh and 0 scatter-add launches.
  mesh_parity
           the TINY model's 64^3 lattice SDF on the card against the same
           weights on the CPU (within 1e-5), and the two meshes: face counts
           within 0.5%, vertices within 1e-4 by nearest-neighbour distance
           both ways.
  ema      ``python -m mlinerf_tpu_torch.train --config
           configs/syn_sphere_ema_a.yaml`` as shipped, 6 steps in process:
           the average against a host replay of the recursion from each
           step's parameters (within the bf16 tolerance of
           tests/test_ema.py), ``ema_params`` in the checkpoint, the
           scatter-add launched in every step; then one ``ema_update`` over
           the syn_prodscale_a trainer's 56.28M parameters timed on the card.
Kernel results are held against the plain version element by element,
within the bound on reordering that element's float32 sum (see
_reorder_tol), or exactly where every order gives the same sum.
Then the ``kernels`` summary line, the card line from nvidia-smi, and
``{"ok": true, ...}`` as the last line. Any failed check raises, so the
script exits non-zero and prints no result.
"""

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TRAIN_STEPS = 6  # 1 warm-up + 5 measured
PRODSCALE = os.path.join(HERE, "configs", "syn_prodscale_a.yaml")
PRODSCALE_B = os.path.join(HERE, "configs", "syn_prodscale_b.yaml")
SMOKE_LOGDIR = os.path.join(HERE, "logs", "chip_smoke")
SMOKE_LOGDIR_B = os.path.join(HERE, "logs", "chip_smoke_b")
SMOKE_LOGDIR_EMA = os.path.join(HERE, "logs", "chip_smoke_ema")
EMA_CONFIG = os.path.join(HERE, "configs", "syn_sphere_ema_a.yaml")
RENDERS = os.path.join(SMOKE_LOGDIR, "output_unpairlights_train")
METRIC_IMAGES = 2
# Lattice side of the mesh phase: the reference extracts at 2048; 512 keeps
# the phase inside the run's time limit.
MESH_RESOLUTION = 512
EMA_TOL = dict(rtol=2e-3, atol=2e-6)  # tests/test_ema.py's bound for bf16 leaves
# Side of the render phase's images. The render is host-bound (about 33,000
# kernel launches per 4096-ray chunk): 16 renders at the config's 256x256
# take about 225 s on an H100, 128x128 a quarter of that.
RENDER_SIZE = 128
TINY = [
    "--model.render.rand_rays=64", "--model.render.num_samples.coarse=16",
    "--model.render.num_samples.fine=4", "--model.render.num_sample_hierarchy=1",
    "--model.object.sdf.mlp.hidden_dim=64", "--model.object.rgb.mlp.hidden_dim=64",
    "--model.object.rgb.mlp.num_layers=2", "--model.object.sdf.encoding.levels=4",
    "--model.object.sdf.encoding.hashgrid.min_logres=3", "--model.object.sdf.encoding.hashgrid.max_logres=6",
    "--model.object.sdf.encoding.hashgrid.dict_size=12", "--model.object.sdf.encoding.hashgrid.dim=2",
    "--model.object.sdf.encoding.hashgrid.dtype=float32", "--model.render.stratified!",
    "--data.train.image_size=[32,32]", "--data.val.image_size=[32,32]",
    "--data.num_cameras=2", "--data.num_lights=2",
]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, iters=20, windows=5):
    """Device milliseconds of one ``fn()``: fn is captured once in a CUDA
    graph, the graph is replayed ``iters`` times back to back between two
    CUDA events, and the median over ``windows`` such runs is divided by
    ``iters``. The graph keeps the host's per-call work (Python, ctypes,
    allocation) out of the time, as it is when a training step keeps the
    card busy."""
    import torch

    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def phase_env():
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), card=card,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32, tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return card


def phase_build():
    from mlinerf_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit("build", seconds=seconds, kernels=cuda_build.kernel_names(), ptxas=ptxas)


def _reorder_tol(idx, vals, s):
    """[S, F] tolerance: atomics sum each row in another order than the
    plain version, and two float32 sums of the same k terms differ by at
    most 2 * k * eps * (sum of the terms' |values|). Each element is bound
    by its own row's hits and its own sum of |vals|."""
    import torch
    from mlinerf_tpu_torch.ops.hashgrid_scatter import scatter_add_rows_reference

    keep = (idx >= 0) & (idx < s)
    hits = torch.bincount(idx[keep].long(), minlength=s).float()
    abs_sum = scatter_add_rows_reference(idx, vals.abs(), s)
    return 2 * hits[:, None] * torch.finfo(torch.float32).eps * abs_sum


def _check_close(got, want, tol, what):
    """Holds got against want element by element within tol ([S, F]);
    returns the largest absolute error and the largest error / tol (0 where
    both are 0)."""
    import torch

    diff = (got - want).abs()
    check(bool(torch.all(diff <= tol)), f"{what}: an element differs from the plain version by more than its tolerance")
    ratio = diff / tol.clamp(min=torch.finfo(torch.float32).tiny)
    return float(diff.max()), float(ratio.max())


def _bound_ms(n, f, s, vals_bytes):
    """Least time for one scatter: idx and vals read once, the float32 table
    written once, against one float32 add per element."""
    bytes_ms = 1e3 * (n * (f * vals_bytes + 4) + s * f * 4) / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n * f / PEAK_F32_OPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _hard_indices(pattern, s, n, gen):
    """Row indices [n] on the card with the structure the kernel's run
    merging must handle."""
    import torch

    if pattern == "uniform":
        return torch.randint(0, s, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if pattern == "one_row":
        return torch.full((n,), 7, device="cuda", dtype=torch.int32)
    if pattern == "long_runs":  # runs of 1-64 equal rows, across warp boundaries
        rows = torch.randint(0, s, (n // 16,), generator=gen, device="cuda", dtype=torch.int32)
    elif pattern == "dropped_runs":  # runs of row 3 between runs of rows S and -1
        rows = torch.tensor([3, s, 3, -1], device="cuda", dtype=torch.int32).repeat(n // 16)
    lens = torch.randint(1, 65 if pattern == "long_runs" else 16, (rows.numel(),), generator=gen, device="cuda")
    out = torch.repeat_interleave(rows, lens)
    check(out.numel() >= n, f"hard case {pattern}: too few rows drawn")
    return out[:n]


def phase_kernel():
    """scatter_add_rows against its plain version: uniform-random rows at
    the training path's shapes (PR 1's cases), the hard cases, and a bf16
    table through TakeRows. Returns the largest error against the plain
    version."""
    import torch
    from mlinerf_tpu_torch.ops.hashgrid_scatter import TakeRows, scatter_add_rows, scatter_add_rows_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    F = 8
    cases = [
        # (name, N rows, table size S, fraction of rows outside the table)
        ("hashed_level_taps", 4 * 1024 * 128 * 8, 2**19, 0.0),
        ("dense_level_center", 1024 * 128 * 8, 33**3, 0.0),
        ("rows_outside_table", 1024 * 128 * 8, 2**19, 0.1),
    ]
    max_err = 0.0
    for name, n, s, oob in cases:
        idx = torch.randint(0, s, (n,), generator=gen, device="cuda", dtype=torch.int32)
        if oob:
            out_rows = torch.rand(n, generator=gen, device="cuda") < oob
            idx = torch.where(out_rows, torch.where(idx % 2 == 0, -1 - idx, s + idx), idx)
        vals = torch.randn(n, F, generator=gen, device="cuda")
        got = scatter_add_rows(idx, vals, s)
        want = scatter_add_rows_reference(idx, vals, s)
        err, err_over_tol = _check_close(got, want, _reorder_tol(idx, vals, s), f"scatter_add_rows {name}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: scatter_add_rows(idx, vals, s))
        plain_ms = cuda_ms(lambda: scatter_add_rows_reference(idx, vals, s))
        library_ms = cuda_ms(lambda: torch.zeros(s, F, device="cuda").index_add_(0, idx, vals)) if not oob else None
        bound_ms, _ = _bound_ms(n, F, s, 4)
        emit("kernel", kernel="scatter_add_rows", case=name, n=n, s=s, f=F, max_abs_err=err,
             err_over_tol=err_over_tol,
             ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             rows_per_s=n / (ms / 1e3))
    # Hard cases. The values are multiples of 1/4 and every sum stays below
    # 2^22, so each order of summation gives the same float32 result: the
    # tolerance is 0.
    hard = []
    n, s = 1024 * 1024 + 17, 33**3  # one row repeated 1M times; N not a multiple of 32
    for pattern in ("one_row", "long_runs", "dropped_runs", "uniform"):
        idx = _hard_indices(pattern, s, n, gen)
        for f in (2, 8, 16):
            quarters = torch.randint(-8, 9, (n, f), generator=gen, device="cuda").float() / 4
            for dtype in (torch.float32, torch.bfloat16):
                vals = quarters.to(dtype)
                got = scatter_add_rows(idx, vals, s)
                want = scatter_add_rows_reference(idx, vals, s)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(err == 0.0, f"scatter_add_rows hard case {pattern} F={f} {dtype}: max abs err {err} != 0")
                hard.append(dict(case=pattern, f=f, vals=str(dtype).replace("torch.", ""), max_abs_err=err,
                                 ms=cuda_ms(lambda: scatter_add_rows(idx, vals, s), iters=10)))
    emit("kernel", kernel="scatter_add_rows", case="hard_cases", n=n, s=s, tol=0.0, cases=hard)
    # A bf16 table through TakeRows: the bf16 cotangent goes to the kernel
    # as it is; the gradient is summed in f32 and cast.
    n, s = cases[0][1], cases[0][2]
    table = torch.zeros(s, F, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    idx = torch.randint(0, s, (n,), generator=gen, device="cuda", dtype=torch.int32)
    cot = torch.randn(n, F, generator=gen, device="cuda").to(torch.bfloat16)
    TakeRows.apply(table, idx).backward(cot)
    want = scatter_add_rows_reference(idx, cot.float(), s).to(torch.bfloat16)
    check(table.grad.dtype == torch.bfloat16, "TakeRows: bf16 table got a non-bf16 gradient")
    got, want = table.grad.float(), want.float()
    # One bf16 ulp, plus the float32 reordering bound for sums that round
    # to a tiny value in one order and to zero in the other.
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(got.abs(), want.abs())
    err, err_over_tol = _check_close(got, want, ulp + _reorder_tol(idx, cot.float(), s), "TakeRows bf16")
    emit("kernel", kernel="scatter_add_rows", case="bf16_table_take_rows_grad", n=n, s=s, f=F,
         max_abs_err=err, err_over_tol=err_over_tol, tol="one bf16 ulp + the reordering bound")
    return max_err


def _tiny_loss(losses, out, target):
    return (3 * losses.l1_loss(out["rgb"], target)
            + 0.1 * losses.eikonal_loss(out["gradients"], outside=out["outside"])
            + 5e-4 * losses.curvature_loss(out["hessians"], outside=out["outside"]))


def phase_parity():
    """The TINY model on the card (kernel backward, cuBLAS without TF32)
    against the same weights on the CPU (the plain path the tests hold
    against the JAX package)."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.models.neuralangelo import make_cond
    from mlinerf_tpu_torch.utils import losses

    cfg = Config(os.path.join(HERE, "configs", "syn_sphere_a.yaml"), cli_args=TINY)
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    rng = np.random.default_rng(0)
    H, W = cfg.data.train.image_size
    ray_idx = rng.permutation(H * W)[:cfg.model.render.rand_rays][None]
    batch = {k: torch.from_numpy(arrays[k][:1]) for k in ("pose", "intr", "pose_light")}
    batch["ray_idx"] = torch.from_numpy(ray_idx)
    batch["image_sampled"] = torch.from_numpy(arrays["images"][:1].reshape(1, H * W, 3)[:, ray_idx[0]])
    cond = make_cond(cfg.model, 10, cfg.max_iter, cfg.optim.sched.warm_up_end)
    model_cls = resolve("model", cfg.model.type)
    results = {}
    state = None
    for device in ("cpu", "cuda"):
        model = model_cls(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0))
        if state is None:
            # Open the encoding columns of the first SDF layer so the table
            # gradients are non-zero.
            with torch.no_grad():
                w = model.neural_sdf.mlp.linear_0.weight
                w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.3
                for t in model.neural_sdf.hash_table:
                    t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        model.to(device)
        out = model({k: v.to(device) for k, v in batch.items()}, cond, train=True)
        loss = _tiny_loss(losses, out, batch["image_sampled"].to(device))
        loss.backward()
        results[device] = dict(
            loss=loss.item(),
            out={k: out[k].detach().cpu() for k in ("rgb", "gradients", "hessians", "weights")},
            grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    cpu, gpu = results["cpu"], results["cuda"]
    errs = {}
    for k in ("rgb", "weights", "gradients"):
        check(bool(torch.isfinite(gpu["out"][k]).all()), f"parity: non-finite {k} on the card")
        errs[k] = float((gpu["out"][k] - cpu["out"][k]).abs().max())
        check(errs[k] <= 1e-4, f"parity: {k} differs by {errs[k]} between the card and the CPU")
    worst = 0.0
    for n, g in cpu["grads"].items():
        rel = float((gpu["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
        check(rel <= 1e-3, f"parity: grad of {n} differs by {rel} of its max between the card and the CPU")
    check(all(float(g.abs().max()) > 0 for n, g in gpu["grads"].items() if "hash_table" in n),
          "parity: a hash table got a zero gradient on the card")
    emit("parity", loss_cpu=cpu["loss"], loss_cuda=gpu["loss"], max_abs_err=errs,
         worst_grad_err_rel_to_leaf_max=worst)


def phase_train(profile: bool):
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    logdir = SMOKE_LOGDIR
    shutil.rmtree(logdir, ignore_errors=True)  # checkpoints and renders of an earlier run
    metrics = os.path.join(logdir, "metrics.jsonl")
    cfg = Config(PRODSCALE, cli_args=["--model.object.sdf.encoding.coarse2fine.enabled!",
                                      f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
                                      f"--checkpoint.save_iter={TRAIN_STEPS}"])
    t0 = time.perf_counter()
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=logdir, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashgrid_scatter.launches = 0
    trainer.train(arrays, show_progress=True)
    launches = hashgrid_scatter.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    records = [json.loads(line) for line in open(metrics)]
    check([r["step"] for r in records] == list(range(1, TRAIN_STEPS + 1)), "train: missing log lines")
    check(all(math.isfinite(r["train/total_loss"]) for r in records), "train: non-finite loss")
    levels = cfg.model.object.sdf.encoding.levels
    check(launches == 2 * levels * TRAIN_STEPS,
          f"train: {launches} scatter_add_rows launches in {TRAIN_STEPS} steps, expected {2 * levels} per step")
    # Geometric init closes the encoding columns of the first SDF layer, so
    # the tables see gradient once the first updates have opened them.
    check(records[-1]["train/table_grad_norm"] > 0, "train: zero hash-table gradient at the last step")
    checkpoint = trainer.checkpointer.read_latest_checkpoint_file()
    check(checkpoint is not None and os.path.basename(checkpoint)
          == trainer.checkpointer.checkpoint_name(trainer.current_epoch, TRAIN_STEPS) and os.path.exists(checkpoint),
          f"train: no checkpoint of iteration {TRAIN_STEPS} behind latest_checkpoint.txt ({checkpoint})")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = cfg.model.render.rand_rays * cfg.data.train.batch_size
    emit("train", config="configs/syn_prodscale_a.yaml", coarse2fine=False, levels=levels,
         rays_per_step=rays, samples_per_ray=cfg.model.render.num_samples.coarse
         + cfg.model.render.num_samples.fine * cfg.model.render.num_sample_hierarchy,
         steps=TRAIN_STEPS, warmup_ms=1e3 * records[0]["train/iter_time"], step_ms=step_ms,
         median_step_ms=ms, rays_per_s=rays / (ms / 1e3), scatter_launches=launches,
         launches_per_step=launches / TRAIN_STEPS, loss=[r["train/total_loss"] for r in records],
         table_grad_norm=[r["train/table_grad_norm"] for r in records], peak_mem_bytes=peak,
         num_params=trainer.num_params, setup_s=setup_s, checkpoint=os.path.relpath(checkpoint, HERE),
         checkpoint_bytes=os.path.getsize(checkpoint))
    arrays = {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()}
    captured = capture_step(trainer, arrays)
    if profile:
        profile_step(trainer, arrays)
    return launches, captured


def capture_step(trainer, arrays):
    """One more train step with the inputs of every scatter_add_rows call
    recorded: [(idx, vals, table_size)], one per launch."""
    import torch
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    original = hashgrid_scatter.scatter_add_rows
    captured = []

    def recording(idx, vals, table_size):
        captured.append((idx.clone(), vals.clone(), table_size))
        return original(idx, vals, table_size)

    before = hashgrid_scatter.launches
    hashgrid_scatter.scatter_add_rows = recording
    try:
        trainer.train_step(trainer.sample_batch(arrays))
        torch.cuda.synchronize()
    finally:
        hashgrid_scatter.scatter_add_rows = original
    launches = hashgrid_scatter.launches - before
    check(launches == len(captured) > 0, f"replay: {launches} launches for {len(captured)} recorded calls")
    return captured


def phase_replay(captured):
    """Each captured launch through the kernel, the plain version and
    index_add_; returns the summary entry with per-step sums."""
    import torch
    from mlinerf_tpu_torch.ops.hashgrid_scatter import scatter_add_rows, scatter_add_rows_reference

    per_launch = []
    for idx, vals, s in captured:
        n, f = vals.shape
        got = scatter_add_rows(idx, vals, s)
        want = scatter_add_rows_reference(idx, vals, s)
        err, err_over_tol = _check_close(got, want, _reorder_tol(idx, vals, s), f"replay: launch {len(per_launch)}")
        keep = (idx >= 0) & (idx < s)
        # index_add_ sums into a float32 table from float32 vals, so it gets
        # vals cast beforehand, outside its timing; it raises on a row
        # outside the table.
        vals32 = vals.float()
        library_ms = (cuda_ms(lambda: torch.zeros(s, f, device="cuda").index_add_(0, idx, vals32))
                      if bool(keep.all()) else None)
        bound_ms, bound_by = _bound_ms(n, f, s, vals.element_size())
        warps = idx[:n // 32 * 32].view(-1, 32)
        per_launch.append(dict(
            n=n, s=s, f=f, vals=str(vals.dtype).replace("torch.", ""),
            ms=cuda_ms(lambda: scatter_add_rows(idx, vals, s)),
            plain_ms=cuda_ms(lambda: scatter_add_rows_reference(idx, vals, s)),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
            err_over_tol=err_over_tol,
            mean_run=n / (1 + int((idx[1:] != idx[:-1]).sum())),
            max_hits=int(torch.bincount(idx[keep].long(), minlength=s).max()),
            runs_per_warp=float(1 + (warps[:, 1:] != warps[:, :-1]).sum(1).float().mean()),
            distinct_per_warp=float(1 + (warps.sort(dim=1).values.diff(dim=1) != 0).sum(1).float().mean())))
    emit("replay", kernel="scatter_add_rows", launches=per_launch)
    step = {k: sum(r[k] for r in per_launch) for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in per_launch]
    step["library_ms"] = None if None in lib else sum(lib)
    step["max_abs_err"] = max(r["max_abs_err"] for r in per_launch)
    worst = max(r["err_over_tol"] for r in per_launch)
    emit("kernel", kernel="scatter_add_rows", case="captured_step", launches=len(per_launch),
         vals=sorted({r["vals"] for r in per_launch}), **step, err_over_tol=worst,
         bound_share=step["bound_ms"] / step["ms"],
         faster_than_library_every_launch=None not in lib
         and all(r["ms"] < r["library_ms"] for r in per_launch))
    bound_by = {r["bound_by"] for r in per_launch}
    return dict(name="scatter_add_rows", route="cuda", source="mlinerf_tpu_torch/csrc/scatter_add_rows.cu",
                replaces="mlinerf_tpu/ops/hashgrid_pallas.py:108", **step,
                bound_by=bound_by.pop() if len(bound_by) == 1 else "bytes")


def profile_step(trainer, arrays):
    """Kernel time by name over two more steps (torch.profiler)."""
    profile_kernels("profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2, unit="step")


def profile_kernels(phase, fn, reps, unit, **fields):
    """Kernel rows of ``reps`` calls of ``fn`` under torch.profiler, per
    call: device busy, wall, idle share, and the top 25 kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # Kernel rows only: an operator's row repeats its kernels' time.
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            rows.append((evt.self_device_time_total, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / reps
    check(busy_ms > 0, f"{phase}: the profiler recorded no kernel time on the card")
    gather_ms = sum(r[0] for r in rows if "vectorized_gather_kernel" in r[1]) / 1e3 / reps
    emit(phase, **fields, **{f"{unit}s": reps, f"wall_ms_per_{unit}": 1e3 * wall / reps,
                             f"device_busy_ms_per_{unit}": busy_ms, f"gather_ms_per_{unit}": gather_ms},
         gather_share_of_busy=gather_ms / busy_ms, idle_share=1 - busy_ms / (1e3 * wall / reps),
         kernel_launches_per_unit=sum(r[2] for r in rows) / reps,
         top=[{"name": k[:160], f"ms_per_{unit}": us / 1e3 / reps, f"calls_per_{unit}": c / reps}
              for us, k, c in rows[:25]])


def _tiny_light_trainers():
    """The TINY light-visibility model on the CPU and on the card, with the
    same weights: the SDF's encoding columns opened a little (the traces
    still converge on the geometric-init sphere) and random tables."""
    import torch
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(os.path.join(HERE, "configs", "syn_sphere_a.yaml"),
                 cli_args=TINY + ["--model.light_visibility.enabled"])
    trainers = {}
    for device in ("cpu", "cuda"):
        trainers[device] = resolve("trainer", cfg.trainer.type)(
            cfg, is_inference=True, seed=0, logdir=os.path.join(SMOKE_LOGDIR + "_tiny", device), device=device)
    model = trainers["cpu"].model
    with torch.no_grad():
        w = model.neural_sdf.mlp.linear_0.weight
        w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.06
        for t in model.neural_sdf.hash_table:
            t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
    trainers["cuda"].model.load_state_dict(model.state_dict())
    for tr in trainers.values():
        tr.current_iteration = 10
    return cfg, trainers


def phase_render_parity():
    """One 32x32 render_image_light of the TINY model on the card against
    the same weights on the CPU."""
    import numpy as np
    from mlinerf_tpu_torch.config import resolve

    cfg, trainers = _tiny_light_trainers()
    sample = resolve("dataset", cfg.data.type)(cfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
    size = cfg.data.val.image_size
    cpu, gpu = (trainers[d].inference_outputs_light(data, size) for d in ("cpu", "cuda"))
    pixels = size[0] * size[1]
    agree = np.ones(size, bool)
    differ = {}
    for key in ("visibility_map", "inter_mask_map"):
        d = gpu[key][0, ..., 0] != cpu[key][0, ..., 0]
        differ[key] = int(d.sum())
        check(differ[key] <= 0.01 * pixels, f"render_parity: {key} differs on {differ[key]} of {pixels} pixels")
        agree &= ~d
    check(0 < cpu["visibility_map"].mean() < 1 and cpu["inter_mask_map"].any(),
          "render_parity: the reference render has no shadow or no surface hit")
    errs = {}
    for key in ("rgb_map", "normal_map", "normal_x_light_map", "depth_map"):
        check(bool(np.isfinite(gpu[key]).all()), f"render_parity: non-finite {key} on the card")
        errs[key] = float(np.abs(gpu[key][0][agree] - cpu[key][0][agree]).max())
        check(errs[key] <= 1e-4, f"render_parity: {key} differs by {errs[key]} between the card and the CPU")
    emit("render_parity", image_size=list(size), pixels=pixels, pixels_differing=differ, max_abs_err=errs, tol=1e-4,
         visibility_share=float(cpu["visibility_map"].mean()), inter_mask_share=float(cpu["inter_mask_map"].mean()))


def phase_render(profile: bool):
    """The pseudo-label render through the inference CLI at full width,
    from the train phase's checkpoint."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all
    from mlinerf_tpu_torch.trainers.base import BaseTrainer

    # Each render_image call, timed to its end (it returns host arrays).
    renders = []
    original = BaseTrainer.render_image

    def timed(self, data, image_size, *args, **kwargs):
        t0 = time.perf_counter()
        out = original(self, data, image_size, *args, **kwargs)
        renders.append((time.perf_counter() - t0, image_size[0] * image_size[1]))
        return out

    size = f"[{RENDER_SIZE},{RENDER_SIZE}]"
    args = ["--config", PRODSCALE, "--logdir", SMOKE_LOGDIR, "--inference_mode", "unpairlights_train",
            "--data.num_cameras=2", "--data.num_lights=2", "--model.object.sdf.encoding.coarse2fine.enabled!",
            f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BaseTrainer.render_image = timed
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = test_cli.main(args)
    finally:
        BaseTrainer.render_image = original
    wall = time.perf_counter() - t0
    scatter_launches = hashgrid_scatter.launches
    peak = torch.cuda.max_memory_allocated()
    check(trainer.current_iteration == TRAIN_STEPS,
          f"render: the checkpoint loaded at iteration {trainer.current_iteration}, not {TRAIN_STEPS}")
    check(scatter_launches == 0, f"render: {scatter_launches} scatter_add_rows launches in a forward-only render")
    results = load_results_all(os.path.join(RENDERS, "results_all"))
    keys = ("normal", "normal_x_light", "rgb_render", "visibility", "inter_mask")
    H, W = trainer.cfg.data.train.image_size
    check(sorted(results) == ["0", "1", "2", "3"] and all(sorted(c) == ["0", "1", "2", "3"] for c in results.values()),
          "render: results_all.npz does not hold 4 cameras x 4 lights")
    maps = [m for c in results.values() for m in c.values()]
    check(all(sorted(m) == sorted(keys) for m in maps), "render: a render lacks one of the 5 keys")
    check(all(m[k].shape[:3] == (1, H, W) and np.isfinite(m[k]).all() for m in maps for k in keys),
          "render: a map has the wrong shape or a non-finite value")
    visibility = np.concatenate([m["visibility"].ravel() for m in maps])
    check(visibility.min() == 0 and visibility.max() == 1, "render: visibility takes only one value")
    inter_share = float(np.mean([m["inter_mask"].mean() for m in maps]))
    check(inter_share > 0, "render: inter_mask is set on no pixel")
    render_s = sum(s for s, _ in renders)
    rays = sum(n for _, n in renders)
    chunk = trainer.num_val_rays()
    emit("render", config="configs/syn_prodscale_a.yaml", mode="unpairlights_train", image_size=[H, W],
         cut=f"image size {RENDER_SIZE}x{RENDER_SIZE}, not the config's 256x256, to keep the phase near 90 s; "
             "widths, samples and chunk size as configured",
         images=len(renders), rays=rays, chunk_rays=chunk, chunks_per_image=math.ceil(H * W / chunk),
         samples_per_ray=trainer.cfg.model.render.num_samples.coarse
         + trainer.cfg.model.render.num_samples.fine * trainer.cfg.model.render.num_sample_hierarchy,
         render_s=render_s, rays_per_s=rays / render_s, ms_per_image=1e3 * render_s / len(renders),
         wall_s=wall, iteration=trainer.current_iteration, scatter_launches=scatter_launches,
         visibility_share=float(visibility.mean()), inter_mask_share=inter_share, peak_mem_bytes=peak)
    if profile:
        sample = resolve("dataset", trainer.cfg.data.type)(trainer.cfg).get_full_sample(0)
        data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
        profile_kernels("render_profile", lambda: trainer.render_image_light(data, (H, W)), reps=1, unit="image",
                        rays=H * W)
        render_layers(trainer, data, (H, W))


def render_layers(trainer, data, image_size):
    """Wall time of one image's render by layer: each layer's calls are
    bracketed by device syncs (which cost the overlap of host and device,
    so the sum is the image's time without overlap)."""
    import torch

    model = trainer.model
    spans = {}
    targets = {"sample_dists_all": model, "eval_field_with_gradients": model, "sphere_trace": model,
               "forward": model.neural_rgb}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed

    for name, owner in targets.items():
        setattr(owner, name, wrap(name, getattr(owner, name)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.render_image_light(data, image_size)
        total = time.perf_counter() - t0
    finally:
        for name, owner in targets.items():
            delattr(owner, name)  # back to the class's methods
    # blend_z_sphere_tracing + sphere_tracing: each chunk traces the camera
    # ray, then the light ray.
    traces = spans.pop("sphere_trace")
    layers = {"sampling": sum(spans["sample_dists_all"]), "field_with_taps": sum(spans["eval_field_with_gradients"]),
              "rgb_head": sum(spans["forward"]), "camera_trace": sum(traces[0::2]),
              "light_trace": sum(traces[1::2])}
    layers["compositing_and_rest"] = total - sum(layers.values())
    emit("render_layers", image_size=list(image_size), synced_total_s=total,
         seconds=layers, share={k: v / total for k, v in layers.items()})


def _record(owner, name, store):
    """Replace ``owner.name`` by a wrapper that appends each call's output
    to ``store``; returns a function that restores it."""
    original = getattr(owner, name)

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        store.append(out)
        return out

    setattr(owner, name, recording)
    return lambda: setattr(owner, name, original)


def phase_pseudo_label_parity():
    """The pseudo-label pipeline on the card against the CPU, on the render
    phase's results_all, with the same first k-means centres. The k-means
    labels and the fill's picks are captured from both runs."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.ops import kmeans, knn
    from mlinerf_tpu_torch.pipelines import pseudo_label as pl
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all

    results = load_results_all(os.path.join(RENDERS, "results_all"))
    _, H, W, _ = results["0"]["0"]["visibility"].shape
    lights = len(results["0"])
    first = kmeans.first_indices(H * W, lights)
    runs = {}
    for device in ("cpu", "cuda"):
        labels, picks = [], []
        restore = [_record(kmeans, "kmeans_per_pixel", labels), _record(knn, "masked_nearest_indices", picks)]
        try:
            out = pl.generate_pseudo_labels(results, "unpair", device=device, first_index=first)
        finally:
            for r in restore:
                r()
        runs[device] = (out, [l[0].cpu() for l in labels], [p.cpu() for p in picks])
    (cpu, cpu_labels, cpu_picks), (gpu, gpu_labels, gpu_picks) = runs["cpu"], runs["cuda"]
    pixels = H * W
    counts, errs = [], {}
    for ci, cam in enumerate(sorted(cpu)):
        for light in results[cam]:
            for key in ("pseudo_shading_gamma", "visibility_certainty"):
                g, c = gpu[cam][light][key], cpu[cam][light][key]
                check(np.isfinite(g).all(), f"pseudo_label_parity: non-finite {key} on the card")
                errs[key] = max(errs.get(key, 0.0), float(np.abs(g - c).max()))
                check(errs[key] <= 1e-5, f"pseudo_label_parity: {key} differs by {errs[key]}")
        label_differ = (gpu_labels[ci] != cpu_labels[ci]).any(dim=1).numpy().reshape(H, W)
        pick_differ = (gpu_picks[ci] != cpu_picks[ci]).numpy().reshape(H, W)
        ref_g, ref_c = gpu[cam]["pseudo_reflectance"], cpu[cam]["pseudo_reflectance"]
        check(np.isfinite(ref_g).all(), "pseudo_label_parity: non-finite reflectance on the card")
        err = np.abs(ref_g - ref_c)
        off = np.any(err > 1e-4 * np.maximum(1.0, np.abs(ref_c)), axis=-1)
        agree = ~label_differ & ~pick_differ
        row = dict(camera=cam, label_pixels_differing=int(label_differ.sum()),
                   pick_pixels_differing=int(pick_differ.sum()), ref_pixels_off=int(off.sum()),
                   ref_pixels_off_where_picks_agree=int((off & agree).sum()),
                   ref_max_abs_err_where_within=float(err[~off].max()))
        counts.append(row)
        for key in ("label_pixels_differing", "pick_pixels_differing", "ref_pixels_off"):
            check(row[key] <= 0.01 * pixels, f"pseudo_label_parity: camera {cam}: {key} = {row[key]} of {pixels}")
    emit("pseudo_label_parity", image_size=[H, W], pixels_per_camera=pixels, cameras=len(cpu), lights=lights,
         max_abs_err=errs, tol={"shading_and_certainty": 1e-5, "reflectance": "1e-4 x max(1, |value|)",
                                "share_of_pixels_differing": 0.01}, cameras_detail=counts)


def _synced_spans(targets):
    """Wrap each (owner, name) so that its calls are timed between device
    syncs; nested calls of wrapped functions count once, in the outermost.
    Returns (spans {name: [seconds]}, restore)."""
    import torch

    spans, depth, originals = {}, [0], []
    for owner, name, label in targets:
        original = getattr(owner, name)
        originals.append((owner, name, original))

        def timed(*args, _fn=original, _label=label, **kwargs):
            if depth[0]:
                return _fn(*args, **kwargs)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spans.setdefault(_label, []).append(time.perf_counter() - t0)
                depth[0] -= 1

        setattr(owner, name, timed)
    return spans, lambda: [setattr(o, n, f) for o, n, f in originals]


def phase_pseudo_label():
    """The pseudo-label CLI in process on the render phase's output."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.ops import kmeans, morphology
    from mlinerf_tpu_torch.pipelines import pseudo_label as pl
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all

    spans, restore = _synced_spans([(kmeans, "kmeans_per_pixel", "kmeans"), (morphology, "erosion", "morphology"),
                                    (morphology, "edge_weight", "morphology"), (pl, "fill_holes_nn", "fill")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out_dir = pl.main(["--workdir", RENDERS, "--setting", "unpair"])
    finally:
        restore()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    labels = load_results_all(os.path.join(out_dir, "pseudo_label_all"))
    results = load_results_all(os.path.join(RENDERS, "results_all"))
    _, H, W, _ = results["0"]["0"]["visibility"].shape
    check(sorted(labels) == ["0", "1", "2", "3"], "pseudo_label: pseudo_label_all.npz does not hold 4 cameras")
    for cam, node in labels.items():
        check(sorted(node) == sorted(["0", "1", "2", "3", "pseudo_reflectance"]),
              f"pseudo_label: camera {cam} lacks a light or the reflectance")
        ref = node["pseudo_reflectance"]
        check(ref.shape == (H, W, 3) and np.isfinite(ref).all() and ref.std() > 0,
              f"pseudo_label: camera {cam}: reflectance of the wrong shape, non-finite or constant")
        for light in ("0", "1", "2", "3"):
            maps = node[light]
            check(sorted(maps) == ["pseudo_shading_gamma", "visibility_certainty"]
                  and all(m.shape == (H, W, 1) and np.isfinite(m).all() for m in maps.values()),
                  f"pseudo_label: camera {cam} light {light}: a map is missing, misshapen or non-finite")
            cert = maps["visibility_certainty"]
            check(cert.min() >= 0 and cert.max() <= 1, f"pseudo_label: certainty outside [0, 1] ({cam}/{light})")
    cams = len(labels)
    per_camera = {k: sum(v) / cams for k, v in spans.items()}

    # The fill alone at the config's 256x256: quadratic in the pixels.
    side = 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    ref = torch.rand(side, side, 3, generator=gen, device="cuda")
    normal = torch.randn(side, side, 3, generator=gen, device="cuda")
    centers = torch.randn(2, 2, side, side, generator=gen, device="cuda")
    mask = torch.rand(side, side, generator=gen, device="cuda") > 0.3
    pl.fill_holes_nn(ref, normal, centers, mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        pl.fill_holes_nn(ref, normal, centers, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    emit("pseudo_label", setting="unpair", image_size=[H, W], cameras=cams, lights_per_camera=len(results["0"]),
         wall_s=wall, s_per_camera=wall / cams, s_per_camera_by_stage=per_camera,
         other_s_per_camera=wall / cams - sum(per_camera.values()), peak_mem_bytes=peak,
         fill_256x256_s=statistics.median(times), fill_256x256_peak_mem_bytes=torch.cuda.max_memory_allocated(),
         output=os.path.relpath(os.path.join(out_dir, "pseudo_label_all.npz"), HERE))


def phase_stage_b_parity():
    """One step of the TINY stage-b model on the card against the CPU."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(os.path.join(HERE, "configs", "syn_sphere_b.yaml"),
                 cli_args=TINY + ["--model.use_pre_trained!", "--data.train.pseudo_label.enabled!",
                                  "--optim.sched.warm_up_end=0"])
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    rng = np.random.default_rng(0)
    H, W = cfg.data.train.image_size
    R = cfg.model.render.rand_rays
    ray_idx = rng.permutation(H * W)[:R][None]
    batch = {k: torch.from_numpy(arrays[k][:1]) for k in ("pose", "intr", "pose_light")}
    batch["ray_idx"] = torch.from_numpy(ray_idx)
    batch["image_sampled"] = torch.from_numpy(arrays["images"][:1].reshape(1, H * W, 3)[:, ray_idx[0]])
    batch["pseudo_ref_sampled"] = torch.from_numpy(rng.uniform(0, 1.2, (1, R, 3)).astype(np.float32))
    batch["pseudo_sha_sampled"] = torch.from_numpy(rng.uniform(0, 1, (1, R, 1)).astype(np.float32))
    batch["pseudo_visibility_certainty_sampled"] = torch.from_numpy(rng.uniform(0, 1, (1, R, 1)).astype(np.float32))
    trainers, state = {}, None
    for device in ("cpu", "cuda"):
        tr = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=os.path.join(SMOKE_LOGDIR + "_tiny_b", device),
                                                  device=device)
        if state is None:
            with torch.no_grad():
                w = tr.model.neural_sdf.mlp.linear_0.weight
                w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.06
                for t in tr.model.neural_sdf.hash_table:
                    t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        tr.model.load_state_dict(state)
        info = tr.train_step({k: v.to(device) for k, v in batch.items()})
        trainers[device] = (tr, {k: float(v) for k, v in info["losses"].items()},
                            {k: v.detach().cpu() for k, v in tr.model.state_dict().items()})
    (_, cpu_losses, cpu_params), (tr, gpu_losses, gpu_params) = trainers["cpu"], trainers["cuda"]
    check(sorted(gpu_losses) == ["curvature", "eikonal", "intrinsic", "regularize_re", "render"],
          f"stage_b_parity: losses {sorted(gpu_losses)}")
    loss_err = {k: abs(gpu_losses[k] - cpu_losses[k]) / max(abs(cpu_losses[k]), 1e-30) for k in cpu_losses}
    check(all(math.isfinite(v) for v in gpu_losses.values()), "stage_b_parity: non-finite loss on the card")
    check(max(loss_err.values()) <= 1e-3, f"stage_b_parity: losses differ by {loss_err} (relative)")
    head_err, moved = 0.0, 0
    for name, p in gpu_params.items():
        if name.startswith("neural_rgb."):
            head_err = max(head_err, float((p - cpu_params[name]).abs().max()))
            moved += int((p != state[name]).sum())
        else:
            check(torch.equal(p, state[name]) and torch.equal(cpu_params[name], state[name]),
                  f"stage_b_parity: frozen parameter {name} changed")
    check(head_err <= 1e-5 and moved > 0, f"stage_b_parity: heads differ by {head_err}, {moved} entries moved")
    check(all(t.grad is None for t in tr.model.neural_sdf.hash_table), "stage_b_parity: a frozen table has a gradient")
    emit("stage_b_parity", network_mode=cfg.model.object.rgb.network_mode, losses_cuda=gpu_losses,
         loss_rel_err=loss_err, loss_tol_rel=1e-3, heads_max_abs_err=head_err, heads_tol=1e-5,
         head_entries_moved=moved, frozen_bitwise_equal=True)


def phase_train_b(profile: bool):
    """Stage-b training through the training CLI at full width, warm-started
    from the train phase's checkpoint, on the pseudo_label phase's labels."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer

    stage_a = os.path.join(SMOKE_LOGDIR, "latest_checkpoint.txt")
    labels = RENDERS + "_pseudo_label/pseudo_label_all.npz"
    shutil.rmtree(SMOKE_LOGDIR_B, ignore_errors=True)
    size = f"[{RENDER_SIZE},{RENDER_SIZE}]"
    args = ["--config", PRODSCALE_B, "--logdir", SMOKE_LOGDIR_B, f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
            "--data.num_cameras=2", "--data.num_lights=2", f"--data.train.image_size={size}",
            f"--data.val.image_size={size}", f"--model.use_pre_trained.pt_filename={stage_a}",
            f"--data.train.pseudo_label.pt_file={labels}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    trainer = train_cli.main(args)
    wall = time.perf_counter() - t0
    scatter_launches = hashgrid_scatter.launches
    peak = torch.cuda.max_memory_allocated()
    check(scatter_launches == 0, f"train_b: {scatter_launches} scatter_add_rows launches with frozen tables")
    records = [json.loads(line) for line in open(os.path.join(SMOKE_LOGDIR_B, "metrics.jsonl"))]
    check([r["step"] for r in records] == list(range(1, TRAIN_STEPS + 1)), "train_b: missing log lines")
    keys = ("render", "eikonal", "curvature", "intrinsic", "regularize_re")
    check(all(math.isfinite(r[f"train/loss/{k}"]) for r in records for k in keys), "train_b: a loss is not finite")
    report = trainer.warm_start_report
    check(any(".mlp_r." in n for n in report["missing"]) and any(".mlp_s." in n for n in report["missing"]),
          "train_b: the warm start does not report mlp_r / mlp_s as missing")
    check(not any(n.startswith("neural_rgb.mlp.") for n in report["missing"] + report["mismatched"]),
          "train_b: the warm start did not carry the stage-a head mlp")
    before = Checkpointer.load_file(stage_a)["state"]["params"]
    after = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    sdf = [k for k in after if k.startswith("neural_sdf.")]
    check(all(torch.equal(after[k], before[k]) for k in sdf), "train_b: a neural_sdf parameter changed")
    moved = [k for k in after if k.startswith("neural_rgb.mlp.") and not torch.equal(after[k], before[k])]
    check(bool(moved), "train_b: no neural_rgb parameter changed")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = trainer.cfg.model.render.rand_rays * trainer.cfg.data.train.batch_size
    emit("train_b", config="configs/syn_prodscale_b.yaml", network_mode=trainer.cfg.model.object.rgb.network_mode,
         cut=f"image size {RENDER_SIZE}x{RENDER_SIZE}, not the config's 256x256, to match the render phase's "
             "labels; 2 cameras x 2 lights; widths, samples and rays per step as configured",
         rays_per_step=rays, steps=TRAIN_STEPS, warmup_ms=1e3 * records[0]["train/iter_time"], step_ms=step_ms,
         median_step_ms=ms, rays_per_s=rays / (ms / 1e3), scatter_launches=scatter_launches,
         losses={k: [r[f"train/loss/{k}"] for r in records] for k in keys},
         trainable_params=sum(p.numel() for p in trainer.optimizer.params), num_params=trainer.num_params,
         warm_start={k: len(v) for k, v in report.items()}, sdf_leaves_bitwise_equal=len(sdf),
         head_leaves_moved=len(moved), peak_mem_bytes=peak, wall_s=wall)
    if profile:
        arrays = {k: torch.as_tensor(v, device="cuda")
                  for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
        profile_kernels("train_b_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2,
                        unit="step")


def _metric_args():
    """The stage-b config at the render phase's cut, with METRIC_IMAGES
    validation images."""
    size = f"[{RENDER_SIZE},{RENDER_SIZE}]"
    return ["--data.num_cameras=2", "--data.num_lights=2", f"--data.train.image_size={size}",
            f"--data.val.image_size={size}", f"--data.val.subset={METRIC_IMAGES}"]


def phase_metrics():
    """image_test of the train_b checkpoint, then the metrics CLI on it."""
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.pipelines import metrics

    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    test_cli.main(["--config", PRODSCALE_B, "--logdir", SMOKE_LOGDIR_B, "--inference_mode", "image_test",
                   *_metric_args()])
    render_s = time.perf_counter() - t0
    out_dir = os.path.join(SMOKE_LOGDIR_B, "output_image")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = metrics.main(["--config", PRODSCALE_B, "--output_dir", out_dir, "--components", "rgb,ref,sha",
                            "--allow_missing_lpips", *_metric_args()])
    wall = time.perf_counter() - t0
    check(hashgrid_scatter.launches == 0, f"metrics: {hashgrid_scatter.launches} scatter_add_rows launches")
    check(sorted(results) == ["ref", "rgb", "sha"], f"metrics: components {sorted(results)}")
    for comp, scores in results.items():
        check(sorted(scores) == ["mse", "psnr", "ssim"] and all(math.isfinite(v) for v in scores.values()),
              f"metrics: {comp} scores {scores}")
    emit("metrics", config="configs/syn_prodscale_b.yaml", images=METRIC_IMAGES, image_size=[RENDER_SIZE] * 2,
         note="6-step models: shows that the path runs, not a quality", scores=results, lpips="no weights",
         image_test_s=render_s, metrics_wall_s=wall, s_per_image=wall / METRIC_IMAGES)
    return out_dir


def _seed_lpips_npz(path, seed=0):
    """AlexNet-LPIPS weights of the production layout, made from a seed."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for i, (cin, cout, k) in enumerate([(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]):
        out[f"conv{i}_w"] = rng.randn(k, k, cin, cout).astype(np.float32) * (2.0 / (k * k * cin)) ** 0.5
        out[f"conv{i}_b"] = (rng.randn(1, 1, 1, cout) * 0.1).astype(np.float32)
        out[f"lin{i}_w"] = rng.rand(1, 1, cout, 1).astype(np.float32)
    np.savez(path, **out)


def phase_metrics_parity(out_dir):
    """The metrics of the image_test PNGs on the card against the CPU."""
    import tempfile

    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.pipelines import metrics
    from mlinerf_tpu_torch.utils.image_io import load_image

    cfg = Config(PRODSCALE_B, cli_args=_metric_args())
    cfg.data.val.load_iid = True
    ds = resolve("dataset", cfg.data.type)(cfg, is_inference=True)
    pairs = []
    for i in range(len(ds)):
        sample = ds.get_full_sample(i)
        for key, gt_key, gamma in (("rgb_map", "image", None), ("o_r_map", "Ref", None), ("o_s_map", "Sha", 2.2)):
            pred = load_image(os.path.join(out_dir, f"{sample['idx']}_{key}.png"))[..., :3]
            pairs.append((key, pred, np.asarray(sample[gt_key])[..., :3], gamma))
    errs, card_s = {}, 0.0
    for key, pred, gt, gamma in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = metrics.calculate_metrics(pred, gt, gamma=gamma, device="cuda")
        card_s += time.perf_counter() - t0
        want = metrics.calculate_metrics(pred, gt, gamma=gamma, device="cpu")
        for k in ("psnr", "ssim", "mse"):
            errs[k] = max(errs.get(k, 0.0), abs(got[k] - want[k]))
            check(abs(got[k] - want[k]) <= 1e-10, f"metrics_parity: {key} {k} {got[k]} on the card, {want[k]} on the CPU")
    saved = os.environ.get("LPIPS_WEIGHTS")
    lpips_err, lpips_vals, lpips_s = 0.0, [], 0.0
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["LPIPS_WEIGHTS"] = os.path.join(tmp, "lpips_seed.npz")
        _seed_lpips_npz(os.environ["LPIPS_WEIGHTS"])
        try:
            for key, pred, gt, _ in pairs:
                metrics.lpips(pred, gt, device="cuda")  # warm-up; the first call loads the weights
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = metrics.lpips(pred, gt, device="cuda")
                lpips_s += time.perf_counter() - t0
                want = metrics.lpips(pred, gt, device="cpu")
                check(got is not None and math.isfinite(got) and abs(got - want) <= 1e-5,
                      f"metrics_parity: LPIPS of {key}: {got} on the card, {want} on the CPU")
                lpips_err = max(lpips_err, abs(got - want))
                lpips_vals.append(got)
        finally:
            metrics._LPIPS_CACHE.clear()
            if saved is None:
                os.environ.pop("LPIPS_WEIGHTS")
            else:
                os.environ["LPIPS_WEIGHTS"] = saved
    check(torch.backends.cudnn.allow_tf32 is False, "metrics_parity: LPIPS did not restore cuDNN's TF32 setting")
    emit("metrics_parity", pairs=len(pairs), image_size=list(pairs[0][1].shape[:2]), max_abs_err=errs, tol=1e-10,
         lpips_seed_weights_max_abs_err=lpips_err, lpips_tol=1e-5, lpips_values=lpips_vals,
         card_s_per_pair=card_s / len(pairs), lpips_card_s_per_pair=lpips_s / len(pairs))


def phase_mesh():
    """The mesh CLI at full width on the train phase's checkpoint."""
    import torch
    from mlinerf_tpu_torch import extract_mesh as mesh_cli
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.ops import mesh as mesh_ops
    from mlinerf_tpu_torch.pipelines import mesh_extract

    # Each device evaluation (it ends in the copy back), split into the SDF
    # lattice and the texture probe by the function evaluated.
    evals, texture_fns = [], []
    original_eval, original_texture = mesh_extract._evaluate, mesh_extract.trainer_texture_fn

    def timed_eval(fn, points, chunk, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original_eval(fn, points, chunk, device)
        evals.append((fn in texture_fns, len(points), time.perf_counter() - t0))
        return out

    def recorded_texture(trainer):
        texture_fns.append(original_texture(trainer))
        return texture_fns[-1]

    spans, restore = _synced_spans([(mesh_ops, "marching_tets", "marching"), (mesh_ops, "weld_vertices", "weld_filter"),
                                    (mesh_extract, "filter_largest_cc", "weld_filter"),
                                    (mesh_ops, "save_ply", "ply_write")])
    mesh_extract._evaluate, mesh_extract.trainer_texture_fn = timed_eval, recorded_texture
    args = ["--config", PRODSCALE, "--logdir", SMOKE_LOGDIR, "--resolution", str(MESH_RESOLUTION), "--block_res", "128",
            "--textured", "--model.object.sdf.encoding.coarse2fine.enabled!", "--data.num_cameras=2",
            "--data.num_lights=2"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    try:
        out, verts, faces, colors = mesh_cli.main(args)
    finally:
        restore()
        mesh_extract._evaluate, mesh_extract.trainer_texture_fn = original_eval, original_texture
    wall = time.perf_counter() - t0
    launches = hashgrid_scatter.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == 0, f"mesh: {launches} scatter_add_rows launches in a forward-only extraction")
    check(len(verts) > 0 and len(faces) > 0 and colors is not None and colors.shape == verts.shape,
          f"mesh: {len(verts)} vertices, {len(faces)} faces, colours {None if colors is None else colors.shape}")
    check(bool((faces >= 0).all() and (faces < len(verts)).all()), "mesh: a face indexes no vertex")
    sdf = [(n, s) for tex, n, s in evals if not tex]
    sdf_points, sdf_s = sum(n for n, _ in sdf), sum(s for _, s in sdf)
    check(sdf_points >= MESH_RESOLUTION**3, f"mesh: {sdf_points} SDF points for a {MESH_RESOLUTION}^3 lattice")
    tex_s = sum(s for tex, _, s in evals if tex)
    stages = {k: sum(v) for k, v in spans.items()}
    emit("mesh", config="configs/syn_prodscale_a.yaml", checkpoint_iteration=TRAIN_STEPS,
         resolution=MESH_RESOLUTION, block_res=128,
         cut=f"lattice {MESH_RESOLUTION}^3, not the reference's usual 2048^3, for the run's time limit; widths as "
             "configured", blocks=len(sdf), sdf_points=sdf_points, sdf_s=sdf_s, sdf_points_per_s=sdf_points / sdf_s,
         marching_s=stages.get("marching", 0.0), weld_filter_s=stages.get("weld_filter", 0.0),
         texture_s=tex_s, ply_write_s=stages.get("ply_write", 0.0), total_s=wall,
         other_s=wall - sdf_s - tex_s - sum(stages.values()), vertices=len(verts), faces=len(faces),
         ply_bytes=os.path.getsize(out), scatter_launches=launches, peak_mem_bytes=peak)


def phase_mesh_parity():
    """The TINY model's lattice SDF and mesh on the card against the CPU."""
    import torch
    from mlinerf_tpu_torch.pipelines import mesh_extract

    _, trainers = _tiny_light_trainers()
    (_, pts), = list(mesh_extract.lattice_blocks((-1, -1, -1), (1, 1, 1), 64, 64))
    flat = pts.reshape(-1, 3)
    sdf = {d: mesh_extract._evaluate(mesh_extract.trainer_sdf_fn(trainers[d]), flat, 262144, torch.device(d))
           for d in ("cpu", "cuda")}
    sdf_err = float(abs(sdf["cuda"] - sdf["cpu"]).max())
    check(sdf_err <= 1e-5, f"mesh_parity: the lattice SDF differs by {sdf_err} between the card and the CPU")
    meshes = {d: mesh_extract.extract_mesh(mesh_extract.trainer_sdf_fn(trainers[d]), resolution=64, block_res=64,
                                           device=d) for d in ("cpu", "cuda")}
    (v_cpu, f_cpu, _), (v_gpu, f_gpu, _) = meshes["cpu"], meshes["cuda"]
    check(len(f_cpu) > 0, "mesh_parity: the TINY model's mesh is empty")
    check(abs(len(f_gpu) - len(f_cpu)) <= 0.005 * len(f_cpu),
          f"mesh_parity: {len(f_gpu)} faces on the card, {len(f_cpu)} on the CPU")
    a, b = torch.from_numpy(v_gpu).cuda(), torch.from_numpy(v_cpu).cuda()

    def farthest_nearest(x, y):
        # Differences, not the |x|^2 + |y|^2 - 2xy expansion, whose float32
        # cancellation alone is about 5e-4 at unit coordinates.
        return max(float(torch.cdist(x[i:i + 4096], y, compute_mode="donot_use_mm_for_euclid_dist")
                         .min(dim=1).values.max()) for i in range(0, len(x), 4096))

    nn = {"card_to_cpu": farthest_nearest(a, b), "cpu_to_card": farthest_nearest(b, a)}
    check(max(nn.values()) <= 1e-4, f"mesh_parity: a vertex is {nn} from the other device's nearest")
    emit("mesh_parity", resolution=64, sdf_max_abs_err=sdf_err, sdf_tol=1e-5, faces_cpu=len(f_cpu),
         faces_cuda=len(f_gpu), vertices_cpu=len(v_cpu), vertices_cuda=len(v_gpu), farthest_nearest_vertex=nn,
         vertex_tol=1e-4, faces_tol_share=0.005)


def phase_ema():
    """configs/syn_sphere_ema_a.yaml through the training CLI, its average
    against a host replay, then ema_update over 56.28M parameters."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.trainers import optim
    from mlinerf_tpu_torch.trainers.base import BaseTrainer
    from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer

    def host(model):
        return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    shutil.rmtree(SMOKE_LOGDIR_EMA, ignore_errors=True)
    states, step_launches = [], []
    original = BaseTrainer.train_step

    def recording(self, batch):
        if not states:
            states.append(host(self.model))
        before = hashgrid_scatter.launches
        info = original(self, batch)
        step_launches.append(hashgrid_scatter.launches - before)
        states.append(host(self.model))
        return info

    BaseTrainer.train_step = recording
    hashgrid_scatter.launches = 0
    try:
        trainer = train_cli.main(["--config", EMA_CONFIG, "--logdir", SMOKE_LOGDIR_EMA, f"--max_iter={TRAIN_STEPS}",
                                  "--logging_iter=1"])
    finally:
        BaseTrainer.train_step = original
    launches = hashgrid_scatter.launches
    check(len(step_launches) == TRAIN_STEPS and all(n > 0 for n in step_launches),
          f"ema: scatter_add_rows launches per step {step_launches}")
    beta = trainer.ema_beta
    check(beta == 0.999, f"ema: beta {beta}, the config ships 0.999")
    # The recursion replayed on the host: in each leaf's dtype with the
    # port's own update, and in float32.
    in_dtype = {k: v.clone() for k, v in states[0].items()}
    in_f32 = {k: v.float() for k, v in states[0].items()}
    for p in states[1:]:
        optim.ema_update(list(in_dtype.values()), [p[k] for k in in_dtype], beta)
        in_f32 = {k: beta * in_f32[k] + (1.0 - beta) * p[k].float() for k in in_f32}
    got = host(trainer.ema_model)
    err_dtype = max(float((got[k].float() - in_dtype[k].float()).abs().max()) for k in got)
    err_f32 = max(float((got[k].float() - in_f32[k]).abs().max()) for k in got)
    for k in got:
        for name, want in (("its dtype", in_dtype[k].float()), ("float32", in_f32[k])):
            check(torch.allclose(got[k].float(), want, **EMA_TOL), f"ema: {k} off the host replay in {name}")
    lag = max(float((got[k].float() - states[-1][k].float()).abs().max()) for k in got)
    check(lag > 0, "ema: the average equals the trained parameters")
    payload = Checkpointer.load_file(os.path.join(SMOKE_LOGDIR_EMA, "latest_checkpoint.txt"))
    saved = payload["state"].get("ema_params")
    check(saved is not None and all(torch.equal(saved[k], got[k]) for k in got),
          "ema: the checkpoint does not carry the average")
    del trainer, states
    # One update over the production model's parameters.
    cfg = Config(PRODSCALE, cli_args=["--trainer.ema_config.enabled"])
    big = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=os.path.join(SMOKE_LOGDIR_EMA, "prodscale"),
                                               device="cuda")
    avg, new = list(big.ema_model.parameters()), list(big.model.parameters())
    numel = sum(p.numel() for p in new)
    update_ms = cuda_ms(lambda: optim.ema_update(avg, new, big.ema_beta))
    # Each leaf's average read and written, its parameter read once.
    bytes_moved = sum(3 * p.numel() * p.element_size() for p in new)
    bound_ms = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    emit("ema", config="configs/syn_sphere_ema_a.yaml", beta=beta, steps=TRAIN_STEPS, scatter_launches=launches,
         launches_per_step=step_launches, max_abs_err_vs_replay_in_dtype=err_dtype,
         max_abs_err_vs_replay_f32=err_f32, tol=EMA_TOL, bitwise_vs_replay_in_dtype=err_dtype == 0.0,
         max_abs_lag=lag, checkpoint_has_ema=True, update_config="configs/syn_prodscale_a.yaml",
         update_params=numel, update_leaves=len(new), update_ms=update_ms, update_bytes=bytes_moved,
         update_bound_ms=bound_ms, update_bound_share=bound_ms / update_ms)
    del big, avg, new
    torch.cuda.empty_cache()


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler breakdowns of two more train steps, one more image render "
                             "and two more stage-b steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "mlinerf_tpu_torch")):
        sys.exit("chip_smoke: run it from the root of a checkout (mlinerf_tpu_torch/ not found)")
    sys.path.insert(0, HERE)
    card = phase_env()
    phase_build()
    max_err = phase_kernel()
    phase_parity()
    phase_render_parity()
    launches, captured = phase_train(profile=args.profile)
    summary = phase_replay(captured)
    del captured  # 2.5 GB of recorded launches, out of the render's peak memory
    phase_render(profile=args.profile)
    phase_pseudo_label_parity()
    phase_pseudo_label()
    phase_stage_b_parity()
    phase_train_b(profile=args.profile)
    out_dir = phase_metrics()
    phase_metrics_parity(out_dir)
    phase_mesh()
    phase_mesh_parity()
    phase_ema()
    summary["max_abs_err"] = max(summary["max_abs_err"], max_err)
    summary["launches"] = launches
    print(json.dumps({"kernels": [summary]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
