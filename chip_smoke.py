#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mlinerf_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of two
                                     # train steps, one image's render and two
                                     # stage-b steps

Phases, each printing one JSON line:
  env      torch/CUDA versions, the card's name and power limit; TF32 off.
  build    nvcc builds every kernel under mlinerf_tpu_torch/csrc and g++ its
           host libraries, all in parallel; registers and spills.
  kernel   each kernel against its plain PyTorch version: uniform-random rows
           at the training path's shapes (with device timings: cuda_ms),
           then the hard cases of the scatter (one row repeated, runs across
           warp boundaries, runs of dropped rows, N not a multiple of 32,
           F = 2, 4 (Instant-NGP's), 8, 16, 32, 64 (a blocked dense level's
           row is 8F), f32 and bf16 vals), then a bf16 table through
           TakeRows.
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
  fixtures the paper's layouts without its images, in a temporary directory:
           ReNe (savannah's intrinsics and the poses of 4 cameras x 4 lights
           of its train split, its 9 val frames with c25l10; raw 1440x1080
           frames) and MLI synthetic (transforms_{train,val}.json with pl_pos
           and camera_angle_x; Img, Ref, Sha, Res RGBA at 512x512), images of
           the procedural scene written with all five PNG row filters; the
           decode and the resize seconds per raw ReNe frame.
  rene_train
           ``python -m mlinerf_tpu_torch.train --config
           configs/rene_savannah_a.yaml`` in process on the ReNe fixture at
           full width (dict 22, L16 F8, bf16 tables, 2048 rays; coarse-to-fine
           off): 1 warm-up + 5 measured steps, the last saving a checkpoint;
           checks uint8 images on the card, finite losses, 32 scatter-add
           launches per step and non-zero table gradients; then one more
           step with its launches recorded (with --profile, the kernel rows
           of two more steps).
  rene_replay
           those 32 dict-22 launches through the kernel, the plain version
           and index_add_, as the replay phase.
  rene_render
           ``--inference_mode lights_train`` (pair) from that checkpoint, 2
           cameras x 2 lights at 270x360, light visibility, box bounds;
           checks rgb_target in results_all.npz and 0 scatter-add launches.
  rene_labels
           ``pipelines.pseudo_label --setting pair`` on that render.
  rene_train_b
           configs/rene_savannah_b.yaml, warm-started from rene_train, on
           those labels: 1 + 5 steps; the SDF bitwise stage a's, the heads
           moved, 0 scatter-add launches.
  rene_test
           ``--inference_mode rene_test`` from the stage-b checkpoint: the
           c25l10 maps and its gt at 270x360.
  hotdog   configs/syn_hotdog_a.yaml on the MLI fixture at full width
           (512x512, dict 22): 1 + 5 steps as rene_train, then image_test of
           one validation image and the metrics CLI (rgb, ref, sha) against
           the fixture's ground truth.
  dataset_parity
           one TINY step on uint8 ReNe images on the card against the same
           weights and picks on the CPU: decoded pixels bitwise equal, losses
           within 1e-3 (relative).
  e2e_parity
           the TINY syn_e2e_a model (auto stencil, blocked dense levels,
           sampling levels) on the card against the CPU, one training
           forward and backward as is, with the corner-sampled gradient
           (top1cot, k=1) on uniforms handed to both, with the subsampled
           gradient and with an occupancy grid: losses, outputs, gradients.
  e2e_train
           ``python -m mlinerf_tpu_torch.train --config configs/syn_e2e_a.yaml``
           in process at full width (L16 F8, dict 19, bf16, 1024 rays at
           32 + 2x16 samples, 256x256; coarse-to-fine off): 1 + 5 steps and a
           checkpoint; checks the scatter launches per step and by row width
           (a blocked dense level's is 8F = 64) and the encoder's gathers per
           step against the count worked out from the config; then one more
           step with its launches recorded (with --profile, its kernel rows).
  e2e_replay
           those launches through the kernel, the plain version and
           index_add_, as the replay phase, with per-width sums.
  e2e_render
           ``--inference_mode lights_train`` from that checkpoint, 1 camera x
           1 light at RENDER_SIZE: the stencil in evaluation, 0 scatter
           launches.
  e2e_train_b
           configs/syn_e2e_b.yaml, warm-started from e2e_train, on the
           pseudo_label phase's labels: 1 + 5 steps, the SDF bitwise stage
           a's, 0 scatter launches.
  variants syn_e2e_a at full width, 1 + 5 steps with each opt-in knob on,
           one at a time: corner_sample (top1cot, k=1), subsample (topk 24,
           stride 8), occupancy (64^3, refreshed every 2 steps) and
           hessian.mode exact on shared_levels 16: step times and launches.
  nerf_parity
           TINY nerf (coarse + fine) and TINY ingp (L4 F4), each in float32
           and with bf16 MLPs, on the card against the same weights and rays
           on the CPU: loss, outputs and every gradient (NERF_PARITY_TOL);
           ingp launches one scatter per level on the card.
  nerf_fixtures
           the NeRF-synthetic stand-in (lego's layout: RGBA 800x800,
           transforms_{train,val}.json; 4 train, 2 val frames) and the LLFF
           one (fern's: poses_bounds.npy, 9 PNG views at 1008x756).
  nerf_train
           ``python -m mlinerf_tpu_torch.train --config
           configs/nerf_blender.yaml`` as shipped, in process (8x256 MLP, L10
           / L4, 2 x 1024 rays at 64 + 128 samples, bf16, Adam, 400x400):
           1 + 5 steps and a checkpoint; 0 scatter launches. With --profile,
           the kernel rows of two more steps.
  ingp_train
           configs/ingp_blender.yaml as shipped (L16 F4, dict 19, float32
           tables, 64-wide MLPs, 256 samples, bf16): 1 + 5 steps, exactly 16
           scatter launches per step, all at F = 4; then one more step with
           its launches recorded (with --profile, the kernel rows).
  ingp_replay
           those 16 launches through the kernel, the plain version and
           index_add_, as the replay phase: per level ms, bound_ms and share.
  llff_train
           configs/nerf_llff.yaml as shipped (NDC, 378x504) on the LLFF
           stand-in: 1 + 5 steps, 0 scatter launches.
  nerf_render
           ``--inference_mode image_test`` of one 400x400 validation frame
           from the nerf_train and ingp_train checkpoints: rays/s, 0 scatter
           launches.
  video    (in the ReNe block, after rene_test) ``--inference_mode
           video_train_0_3`` from the rene_train_b checkpoint, test_video
           cut to VIDEO_FRAMES frames: the APNG read back (frame count and
           collage shape), 0 scatter launches.
  angelo_parity
           the TINY neuralangelo model with the background NeRF and
           appearance embeddings, and the TINY Lumen model with analytical
           gradients, each one training forward and backward on the card
           against the same weights on the CPU: outputs, Hessians, every
           gradient; their scatter launches on the card.
  angelo_train
           configs/syn_prodscale_a.yaml as ``model.type: neuralangelo``
           with the background at base_sdf.yaml's widths and dim-8
           embeddings over its 12 frames, through the training CLI: 1 + 5
           steps and a checkpoint with the JAX package's leaf names; 32
           scatter launches per step. With --profile, its kernel rows.
  analytical_train
           syn_prodscale_a with ``gradient.mode: analytical`` (1024 rays,
           64 + 16x4 samples): 1 + 5 steps, 16 scatter launches per step,
           peak memory; then one more step with its launches recorded
           (with --profile, its kernel rows).
  analytical_replay
           those 16 launches through the kernel, the plain version and
           index_add_, as the replay phase.
  angelo_render
           ``--inference_mode image_test`` of one 256x256 frame from the
           angelo_train checkpoint: rays/s, 0 scatter launches.
  ddp_parity
           two gloo ranks on the card (spawned here; NCCL refuses two ranks
           on one card), the TINY model, two steps of each layout on one
           injected global batch against one process on the card:
           grad_psum True against the mean of the two half batches'
           gradients, False against the whole batch (stage a, and stage b
           with its coupled losses), shard_tables against replicated; the
           ranks' parameters bitwise equal; scatter launches per rank.
  ddp_train
           ``python -m torch.distributed.run --nproc_per_node=<cards> -m
           mlinerf_tpu_torch.train`` on configs/syn_prodscale_a.yaml at full
           width with ``--runtime.grad_psum=True`` (NCCL; on one card a world
           of 1, whose all-reduce still runs), 1 + 5 steps: ms per step, the
           combine's ms (CUDA events) and bytes per step, peak memory and
           scatter launches per rank; rank 0 alone writes; the checkpoint
           loads in one process.
  ddp2_train
           the same config at full width on two gloo ranks on the one card
           (512 rays each) through the training CLI in each rank, the
           grad_psum and the shard_tables arms, 1 + 3 steps each: the same
           fields, and the moments' bytes per rank; then one rank's 32
           launches (a step of its 512 rays) replayed as in the replay
           phase (``ddp2_replay``).
  runtime  the trainer's runtime options on the card: grad_accum_iter 2, SGD
           and RAdam (TINY, card against CPU from the same weights and
           batch), trainer.init.type xavier, a validation writing its three
           PNGs, and ``train.py --profile`` for two steps of
           syn_prodscale_a, whose scatter row must name the kernel.
  amp_parity
           the TINY Lumen model, and the TINY neuralangelo model with the
           background and embeddings, with bf16 MLPs
           (``trainer.amp_config.enabled``): one training forward and
           backward on the card against the CPU within AMP_TOL (the bounds
           of tests/test_torch_amp.py); 2 scatter launches per level.
  amp_train
           configs/syn_prodscale_a.yaml with ``--trainer.amp_config.enabled``
           through the training CLI: 1 + 5 steps, 32 scatter launches per
           step, bf16 cotangents into the scatter; step ms and peak memory
           beside the train phase's; then one more step with its launches
           recorded.
  amp_replay
           those 32 launches through the kernel, the plain version and
           index_add_, as the replay phase.
  camera   the camera functions beyond the rays and NDC (pose algebra,
           quaternions, the Lie maps, the transforms, the frustum test, the
           spherical-cap samplers on injected uniforms) on the card against
           the CPU; the hemisphere unwrap bitwise at N = 4096, then at the
           probe's default N = 90,000 on the card (timed).
  indirect_probe
           the indirect-light probe on the train phase's checkpoint at the
           JAX package's defaults (resolution 300, grid fraction 0.3) on a
           view cut to PROBE_SIZE (one probed pixel, 90,000 secondary
           rays): mosaic shape, finite values, 0 scatter launches, seconds,
           peak memory.
  bench    ``python -m mlinerf_tpu_torch.bench`` in process at its default
           config with BENCH_SKIP_RENDER: bench.py's JSON line, one scatter
           launch per live level per step (4 of 16 at its first steps).
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
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
HOST_LIBRARIES = ("marching_tets", "png_unfilter")  # csrc/*.cpp, built with g++
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
# The paper's datasets (ReNe savannah, MLI synthetic hotdog) on fixtures in
# their layouts, at their configs' widths (dict 22).
RENE_A = os.path.join(HERE, "configs", "rene_savannah_a.yaml")
RENE_B = os.path.join(HERE, "configs", "rene_savannah_b.yaml")
HOTDOG_A = os.path.join(HERE, "configs", "syn_hotdog_a.yaml")
RENE_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_rene")
RENE_LOGDIR_B = os.path.join(HERE, "logs", "chip_smoke_rene_b")
HOTDOG_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_hotdog")
RENE_CAMERAS = 4  # 4 cameras x 4 lights of savannah's train split
RENE_RENDER_CAMERAS = 2  # the render and stage b: 2 cameras x 2 lights
RENE_RENDER_SIZE = (270, 360)  # the config's image size
HOTDOG_FRAMES = 4
# The JAX package's shipped fast-path semantics (configs/syn_e2e_{a,b}.yaml:
# the auto stencil, blocked dense levels, sampling levels, 32 + 2x16
# samples), and its opt-in knobs one at a time.
E2E_A = os.path.join(HERE, "configs", "syn_e2e_a.yaml")
E2E_B = os.path.join(HERE, "configs", "syn_e2e_b.yaml")
E2E_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_e2e")
E2E_LOGDIR_B = os.path.join(HERE, "logs", "chip_smoke_e2e_b")
E2E_VARIANTS = {
    "corner_sample": ["--model.object.sdf.gradient.corner_sample.enabled",
                      "--model.object.sdf.gradient.corner_sample.mode=top1cot",
                      "--model.object.sdf.gradient.corner_sample.corners=1"],
    "subsample": ["--model.object.sdf.gradient.subsample.enabled", "--model.object.sdf.gradient.subsample.topk=24",
                  "--model.object.sdf.gradient.subsample.stride=8"],
    "occupancy": ["--model.render.occupancy.enabled", "--model.render.occupancy.resolution=64",
                  "--model.render.occupancy.update_every=2"],
    "hessian_exact": ["--model.object.sdf.gradient.shared_levels=16", "--model.object.sdf.gradient.hessian.mode=exact"],
}
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
    # The CUDA kernels with nvcc and the host libraries with g++, all at once.
    logs = cuda_build.build(cuda_build.kernel_names() + list(HOST_LIBRARIES))
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
             for name, log in logs.items() if name not in HOST_LIBRARIES}
    emit("build", seconds=seconds, kernels=cuda_build.kernel_names(), host_libraries=list(HOST_LIBRARIES), ptxas=ptxas)


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
        for f in (2, 4, 8, 16, 32, 64):
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


def _tiny_batch(cfg):
    """The first image of the config's dataset and rand_rays of its pixels,
    picked from seed 0, on the CPU."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import resolve

    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    rng = np.random.default_rng(0)
    H, W = cfg.data.train.image_size
    ray_idx = rng.permutation(H * W)[:cfg.model.render.rand_rays][None]
    batch = {k: torch.from_numpy(arrays[k][:1]) for k in ("pose", "intr", "pose_light")}
    batch["idx"] = torch.zeros(1, dtype=torch.int64)
    batch["ray_idx"] = torch.from_numpy(ray_idx)
    batch["image_sampled"] = torch.from_numpy(arrays["images"][:1].reshape(1, H * W, 3)[:, ray_idx[0]])
    return batch


def phase_parity():
    """The TINY model on the card (kernel backward, cuBLAS without TF32)
    against the same weights on the CPU (the plain path the tests hold
    against the JAX package)."""
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.models.neuralangelo import make_cond
    from mlinerf_tpu_torch.utils import losses

    cfg = Config(os.path.join(HERE, "configs", "syn_sphere_a.yaml"), cli_args=TINY)
    batch = _tiny_batch(cfg)
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
    return launches, captured, dict(median_step_ms=ms, peak_mem_bytes=peak)


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


def phase_replay(captured, phase="replay", case="captured_step"):
    """Each captured launch through the kernel, the plain version and
    index_add_; returns the summary entry with per-step sums."""
    import torch
    from mlinerf_tpu_torch.ops.hashgrid_scatter import scatter_add_rows, scatter_add_rows_reference

    per_launch = []
    for idx, vals, s in captured:
        n, f = vals.shape
        got = scatter_add_rows(idx, vals, s)
        want = scatter_add_rows_reference(idx, vals, s)
        err, err_over_tol = _check_close(got, want, _reorder_tol(idx, vals, s), f"{phase}: launch {len(per_launch)}")
        keep = (idx >= 0) & (idx < s)
        # index_add_ sums into a float32 table from float32 vals, so it gets
        # vals cast beforehand, outside its timing; it raises on a row
        # outside the table.
        vals32 = vals.float()
        library_ms = (cuda_ms(lambda: torch.zeros(s, f, device="cuda").index_add_(0, idx, vals32))
                      if bool(keep.all()) else None)
        # The forward of the same lookup: the row gather (index_select) of
        # a table in the cotangent's dtype (the table's), for kernel 2.2.
        table = torch.zeros(s, f, dtype=vals.dtype, device="cuda")
        gather_ms = cuda_ms(lambda: table.index_select(0, idx)) if bool(keep.all()) else None
        bound_ms, bound_by = _bound_ms(n, f, s, vals.element_size())
        warps = idx[:n // 32 * 32].view(-1, 32)
        ms = cuda_ms(lambda: scatter_add_rows(idx, vals, s))
        per_launch.append(dict(
            n=n, s=s, f=f, vals=str(vals.dtype).replace("torch.", ""), ms=ms,
            plain_ms=cuda_ms(lambda: scatter_add_rows_reference(idx, vals, s)),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
            forward_gather_ms=gather_ms, max_abs_err=err,
            err_over_tol=err_over_tol,
            mean_run=n / (1 + int((idx[1:] != idx[:-1]).sum())),
            max_hits=int(torch.bincount(idx[keep].long(), minlength=s).max()),
            runs_per_warp=float(1 + (warps[:, 1:] != warps[:, :-1]).sum(1).float().mean()),
            distinct_per_warp=float(1 + (warps.sort(dim=1).values.diff(dim=1) != 0).sum(1).float().mean())))
    emit(phase, kernel="scatter_add_rows", launches=per_launch)
    step = {k: sum(r[k] for r in per_launch) for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in per_launch]
    step["library_ms"] = None if None in lib else sum(lib)
    gathers = [r["forward_gather_ms"] for r in per_launch]
    forward_gather_ms = None if None in gathers else sum(gathers)
    step["max_abs_err"] = max(r["max_abs_err"] for r in per_launch)
    worst = max(r["err_over_tol"] for r in per_launch)
    by_width = {}
    for r in per_launch:
        w = by_width.setdefault(str(r["f"]), dict(launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0))
        w["launches"] += 1
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            w[k] = None if w[k] is None or r[k] is None else w[k] + r[k]
    emit("kernel", kernel="scatter_add_rows", case=case, launches=len(per_launch),
         vals=sorted({r["vals"] for r in per_launch}), **step, err_over_tol=worst, by_row_width=by_width,
         forward_gather_ms=forward_gather_ms,
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

    size = f"[{RENDER_SIZE},{RENDER_SIZE}]"
    args = ["--config", PRODSCALE, "--logdir", SMOKE_LOGDIR, "--inference_mode", "unpairlights_train",
            "--data.num_cameras=2", "--data.num_lights=2", "--model.object.sdf.encoding.coarse2fine.enabled!",
            f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    renders, restore = _timed_renders()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = test_cli.main(args)
    finally:
        restore()
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


def _timed_renders():
    """Wrap BaseTrainer.render_image to record (seconds, rays) of each call,
    timed to its end (it returns host arrays); returns the records and a
    function that restores it."""
    from mlinerf_tpu_torch.trainers.base import BaseTrainer

    renders = []
    original = BaseTrainer.render_image

    def timed(self, data, image_size, *args, **kwargs):
        t0 = time.perf_counter()
        out = original(self, data, image_size, *args, **kwargs)
        renders.append((time.perf_counter() - t0, image_size[0] * image_size[1]))
        return out

    BaseTrainer.render_image = timed
    return renders, lambda: setattr(BaseTrainer, "render_image", original)


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
    batch["idx"] = torch.zeros(1, dtype=torch.int64)
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


# ---------------------------------------------------------------------------
# The paper's datasets: ReNe and MLI-synthetic fixtures through the pipeline
# ---------------------------------------------------------------------------


def _fixture_args(fx, name, annotation="train"):
    """Overrides that point a paper config at a fixture of phase_fixtures."""
    root, ann = fx[name]
    return [f"--data.root={root}", f"--data.train.annotation={ann[annotation]}", f"--data.val.annotation={ann['val']}"]


def phase_fixtures(tmp):
    """The ReNe and MLI-synthetic fixtures, PNGs written with every row
    filter (mostly Paeth); the decode and the resize of the raw ReNe frames
    timed on their own."""
    import numpy as np
    from mlinerf_tpu_torch.data import fixtures
    from mlinerf_tpu_torch.utils import image_io

    t0 = time.perf_counter()
    rene_root = os.path.join(tmp, "rene_savannah")
    rene = fixtures.write_rene(rene_root, os.path.join(HERE, "dataset_rene", "savannah"), cameras=RENE_CAMERAS,
                               lights=RENE_CAMERAS, save=fixtures.filtered_saver(0), seed=0)
    rene_s = time.perf_counter() - t0
    # The render and stage b read 2 cameras x 2 lights of the train split.
    with open(rene["train"]) as f:
        meta = json.load(f)
    cams = sorted({fr["camera_index"] for fr in meta["frames"]})[:RENE_RENDER_CAMERAS]
    lights = sorted({fr["light_index"] for fr in meta["frames"]})[:RENE_RENDER_CAMERAS]
    meta["frames"] = [fr for fr in meta["frames"] if fr["camera_index"] in cams and fr["light_index"] in lights]
    rene["render"] = os.path.join(rene_root, "render_transforms.json")
    with open(rene["render"], "w") as f:
        json.dump(meta, f)
    t0 = time.perf_counter()
    mli_root = os.path.join(tmp, "mli_hotdog")
    mli = fixtures.write_point_light(mli_root, image_size=512, train=HOTDOG_FRAMES, val=2, lights=2,
                                     save=fixtures.filtered_saver(1), seed=1)
    mli_s = time.perf_counter() - t0
    # Decode and resize of the raw frames, each timed alone.
    with open(rene["val"]) as f:
        paths = [os.path.normpath(os.path.join(rene_root, fr["file_path"])) for fr in json.load(f)["frames"]]
    image_io.read_png(paths[0])  # builds the row-filter library if needed
    decode, resize = [], []
    for path in paths:
        t1 = time.perf_counter()
        raw = image_io.read_png(path)
        decode.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        small = image_io.resize(raw, (360, 270))
        resize.append(time.perf_counter() - t1)
    check(raw.shape == (1080, 1440, 3) and small.shape == (270, 360, 3), f"fixtures: raw {raw.shape}, resized {small.shape}")
    # Every filter type present in a file (each row's filter byte).
    data, h, w, c = image_io.inflate_png(paths[0])
    rows = np.frombuffer(data, np.uint8).reshape(h, w * c + 1)[:, 0]
    filters = {int(k): int(v) for k, v in zip(*np.unique(rows, return_counts=True))}
    check(sorted(filters) == [0, 1, 2, 3, 4], f"fixtures: row filters {filters}, expected all five")
    frames = {k: len(json.load(open(v))["frames"]) for k, v in rene.items()}
    emit("fixtures", rene=dict(root="<tmp>/rene_savannah", frames=frames, raw_size=[1440, 1080],
                               annotations="dataset_rene/savannah (intrinsics, poses, light poses)", write_s=rene_s),
         mli=dict(root="<tmp>/mli_hotdog", frames={k: len(json.load(open(v))["frames"]) for k, v in mli.items()},
                  image_size=[512, 512], files_per_frame=["Img", "Ref", "Sha", "Res"], write_s=mli_s),
         row_filters_of_one_frame=filters, frames_timed=len(paths),
         decode_s_per_raw_frame=statistics.median(decode), resize_s_per_raw_frame=statistics.median(resize),
         decode_s=decode, resize_s=resize, resize_to=[360, 270])
    return {"rene": (rene_root, rene), "mli": (mli_root, mli)}


def _device_arrays_probe(store):
    """Wrap BaseTrainer.sample_batch to record the dtype, device and bytes
    of the arrays it picks from; returns a function that restores it."""
    from mlinerf_tpu_torch.trainers.base import BaseTrainer

    original = BaseTrainer.sample_batch

    def probing(self, arrays):
        if not store:
            store.update({k: (str(v.dtype), str(v.device), v.numel() * v.element_size()) for k, v in arrays.items()})
        return original(self, arrays)

    BaseTrainer.sample_batch = probing
    return lambda: setattr(BaseTrainer, "sample_batch", original)


def _train_paper_config(phase, config, logdir, extra, images_dtype="torch.uint8", scatters_per_level=2):
    """``python -m mlinerf_tpu_torch.train`` in process at full width, all
    hash levels live, TRAIN_STEPS steps, the last of which saves a
    checkpoint; checks the images on the card (as ``images_dtype``), finite
    losses, ``scatters_per_level`` scatter launches per live level per step
    (2: the centre's and the taps' lookups) and a non-zero table gradient.
    Returns (trainer, fields of the phase line)."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    shutil.rmtree(logdir, ignore_errors=True)
    args = ["--config", config, "--logdir", logdir, f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
            f"--checkpoint.save_iter={TRAIN_STEPS}", "--model.object.sdf.encoding.coarse2fine.enabled!", *extra]
    probe = {}
    restore = _device_arrays_probe(probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main(args)
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = hashgrid_scatter.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.cfg
    check(probe["images"][:2] == (images_dtype, "cuda:0"), f"{phase}: images on the card as {probe['images'][:2]}")
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    check([r["step"] for r in records] == list(range(1, TRAIN_STEPS + 1)), f"{phase}: missing log lines")
    check(all(math.isfinite(r["train/total_loss"]) for r in records), f"{phase}: non-finite loss")
    enc = cfg.model.object.sdf.encoding
    per_step = scatters_per_level * enc.levels
    check(launches == per_step * TRAIN_STEPS,
          f"{phase}: {launches} scatter_add_rows launches in {TRAIN_STEPS} steps, expected {per_step} per step")
    check(records[-1]["train/table_grad_norm"] > 0, f"{phase}: zero hash-table gradient at the last step")
    checkpoint = os.path.join(logdir, trainer.checkpointer.checkpoint_name(trainer.current_epoch, TRAIN_STEPS))
    check(os.path.exists(checkpoint), f"{phase}: no checkpoint of iteration {TRAIN_STEPS}")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = cfg.model.render.rand_rays * cfg.data.train.batch_size
    fields = dict(config=os.path.relpath(config, HERE), image_size=list(cfg.data.train.image_size),
                  frames=probe["pose"][2] // (12 * 4), dict_size=enc.hashgrid.dict_size, levels=enc.levels,
                  feature_dim=enc.hashgrid.dim, table_dtype=enc.hashgrid.get("dtype"), coarse2fine=False,
                  rays_per_step=rays, samples_per_ray=cfg.model.render.num_samples.coarse
                  + cfg.model.render.num_samples.fine * cfg.model.render.num_sample_hierarchy,
                  steps=TRAIN_STEPS, warmup_ms=1e3 * records[0]["train/iter_time"], step_ms=step_ms,
                  median_step_ms=ms, rays_per_s=rays / (ms / 1e3), scatter_launches=launches,
                  launches_per_step=launches / TRAIN_STEPS, loss=[r["train/total_loss"] for r in records],
                  table_grad_norm=[r["train/table_grad_norm"] for r in records], peak_mem_bytes=peak,
                  num_params=trainer.num_params, device_arrays={k: {"dtype": v[0], "device": v[1], "bytes": v[2]}
                                                                for k, v in probe.items()},
                  checkpoint=os.path.relpath(checkpoint, HERE), checkpoint_bytes=os.path.getsize(checkpoint),
                  wall_s=wall)
    return trainer, fields


def phase_rene_train(fx, profile: bool):
    """configs/rene_savannah_a.yaml through the training CLI on the ReNe
    fixture at full width (dict 22), then one more step with its scatter
    launches recorded."""
    import torch
    from mlinerf_tpu_torch.config import resolve

    trainer, fields = _train_paper_config("rene_train", RENE_A, RENE_LOGDIR, _fixture_args(fx, "rene"))
    emit("rene_train", cut="coarse-to-fine off (all 16 levels live); 6 steps; 4 cameras x 4 lights of the "
                           "fixture", **fields)
    arrays = {k: torch.as_tensor(v, device="cuda")
              for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
    captured = capture_step(trainer, arrays)
    check(len(captured) == 2 * trainer.cfg.model.object.sdf.encoding.levels,
          f"rene_train: {len(captured)} launches recorded in one step")
    if profile:
        profile_kernels("rene_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2, unit="step")
    del trainer, arrays
    torch.cuda.empty_cache()
    return fields["scatter_launches"], captured


def _no_scatter(phase, fn):
    """Run fn(); check that it launched no scatter-add; returns its value."""
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    hashgrid_scatter.launches = 0
    out = fn()
    check(hashgrid_scatter.launches == 0, f"{phase}: {hashgrid_scatter.launches} scatter_add_rows launches")
    return out


def phase_rene_render(fx):
    """``lights_train`` (the pair setting) from the rene_train checkpoint:
    2 cameras x 2 lights with light visibility, box bounds."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all

    size = f"[{RENE_RENDER_SIZE[0]},{RENE_RENDER_SIZE[1]}]"
    args = ["--config", RENE_A, "--logdir", RENE_LOGDIR, "--inference_mode", "lights_train",
            "--model.object.sdf.encoding.coarse2fine.enabled!", *_fixture_args(fx, "rene", "render"),
            f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = _no_scatter("rene_render", lambda: test_cli.main(args))
    wall = time.perf_counter() - t0
    check(trainer.current_iteration == TRAIN_STEPS, f"rene_render: checkpoint at iteration {trainer.current_iteration}")
    check(trainer.cfg.data.bounding_type == "box", "rene_render: the config's box bounds are not in use")
    results = load_results_all(os.path.join(RENE_LOGDIR, "output_lights_train", "results_all"))
    H, W = RENE_RENDER_SIZE
    check(len(results) == RENE_RENDER_CAMERAS and all(len(c) == RENE_RENDER_CAMERAS for c in results.values()),
          f"rene_render: results_all holds {[(k, sorted(v)) for k, v in results.items()]}")
    maps = [m for c in results.values() for m in c.values()]
    keys = ("inter_mask", "normal", "normal_x_light", "rgb_render", "rgb_target", "visibility")
    check(all(sorted(m) == list(keys) for m in maps), "rene_render: a render lacks rgb_target or a map")
    check(all(m[k].shape[:3] == (1, H, W) and np.isfinite(m[k]).all() for m in maps for k in keys),
          "rene_render: a map has the wrong shape or a non-finite value")
    check(all(m["rgb_target"].std() > 0 for m in maps), "rene_render: an rgb_target is constant")
    renders = len(maps)
    emit("rene_render", config="configs/rene_savannah_a.yaml", mode="lights_train (pair)", image_size=[H, W],
         cameras=len(results), lights_per_camera=RENE_RENDER_CAMERAS, renders=renders, rays=renders * H * W,
         wall_s=wall, rays_per_s_wall=renders * H * W / wall, bounding_type="box", scatter_launches=0,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    del trainer
    torch.cuda.empty_cache()


def phase_rene_labels():
    """``pipelines.pseudo_label --setting pair`` on the rene_render output."""
    import numpy as np
    from mlinerf_tpu_torch.pipelines import pseudo_label as pl
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all

    t0 = time.perf_counter()
    out_dir = _no_scatter("rene_labels", lambda: pl.main(["--workdir", os.path.join(RENE_LOGDIR, "output_lights_train"),
                                                          "--setting", "pair"]))
    wall = time.perf_counter() - t0
    labels = load_results_all(os.path.join(out_dir, "pseudo_label_all"))
    H, W = RENE_RENDER_SIZE
    for cam, node in labels.items():
        lights = [k for k in node if k != "pseudo_reflectance"]
        check(len(lights) == RENE_RENDER_CAMERAS and node["pseudo_reflectance"].shape == (H, W, 3)
              and all(node[l]["pseudo_shading_gamma"].shape == (H, W, 1) for l in lights)
              and all(np.isfinite(v).all() for l in lights for v in node[l].values()),
              f"rene_labels: camera {cam} lacks a light or has a misshapen or non-finite map")
    emit("rene_labels", setting="pair", cameras=len(labels), image_size=[H, W], wall_s=wall,
         s_per_camera=wall / len(labels), scatter_launches=0,
         output=os.path.relpath(os.path.join(out_dir, "pseudo_label_all.npz"), HERE))
    return os.path.join(out_dir, "pseudo_label_all.npz")


def phase_rene_train_b(fx, labels):
    """configs/rene_savannah_b.yaml through the training CLI, warm-started
    from rene_train, on rene_labels' labels (the render's frames)."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer

    stage_a = os.path.join(RENE_LOGDIR, "latest_checkpoint.txt")
    shutil.rmtree(RENE_LOGDIR_B, ignore_errors=True)
    size = f"[{RENE_RENDER_SIZE[0]},{RENE_RENDER_SIZE[1]}]"
    args = ["--config", RENE_B, "--logdir", RENE_LOGDIR_B, f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
            *_fixture_args(fx, "rene", "render"), f"--data.train.image_size={size}", f"--data.val.image_size={size}",
            f"--model.use_pre_trained.pt_filename={stage_a}", f"--data.train.pseudo_label.pt_file={labels}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = _no_scatter("rene_train_b", lambda: train_cli.main(args))
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in open(os.path.join(RENE_LOGDIR_B, "metrics.jsonl"))]
    keys = ("render", "eikonal", "curvature", "intrinsic", "regularize_re")
    check(all(math.isfinite(r[f"train/loss/{k}"]) for r in records for k in keys), "rene_train_b: a loss is not finite")
    before = Checkpointer.load_file(stage_a)["state"]["params"]
    after = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    sdf = [k for k in after if k.startswith("neural_sdf.")]
    check(all(torch.equal(after[k], before[k]) for k in sdf), "rene_train_b: a neural_sdf parameter changed")
    moved = [k for k in after if k.startswith("neural_rgb.") and (k not in before or not torch.equal(after[k], before[k]))]
    check(any(".mlp_r." in k for k in moved) and any(".mlp_s." in k for k in moved), "rene_train_b: the heads did not move")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = trainer.cfg.model.render.rand_rays * trainer.cfg.data.train.batch_size
    emit("rene_train_b", config="configs/rene_savannah_b.yaml", image_size=list(RENE_RENDER_SIZE),
         cut=f"{RENE_RENDER_CAMERAS} cameras x {RENE_RENDER_CAMERAS} lights (the render's frames); 6 steps",
         steps=TRAIN_STEPS, step_ms=step_ms, median_step_ms=ms, rays_per_s=rays / (ms / 1e3), scatter_launches=0,
         losses={k: [r[f"train/loss/{k}"] for r in records] for k in keys}, sdf_leaves_bitwise_equal=len(sdf),
         head_leaves_moved=len(moved), peak_mem_bytes=torch.cuda.max_memory_allocated(), wall_s=wall)
    del trainer
    torch.cuda.empty_cache()


def phase_rene_test(fx):
    """``--inference_mode rene_test`` from the stage-b checkpoint: c25l10."""
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.utils.image_io import read_png

    size = f"[{RENE_RENDER_SIZE[0]},{RENE_RENDER_SIZE[1]}]"
    args = ["--config", RENE_B, "--logdir", RENE_LOGDIR_B, "--inference_mode", "rene_test",
            *_fixture_args(fx, "rene", "render"), f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    t0 = time.perf_counter()
    _no_scatter("rene_test", lambda: test_cli.main(args))
    wall = time.perf_counter() - t0
    out = os.path.join(RENE_LOGDIR_B, "output_rene")
    shapes = {}
    for key in ("rgb_map", "o_r_map", "o_s_map", "gt"):
        path = os.path.join(out, f"c25l10_{key}.png")
        check(os.path.exists(path), f"rene_test: {path} missing")
        shapes[key] = list(read_png(path).shape)
        check(shapes[key] == [*RENE_RENDER_SIZE, 3], f"rene_test: c25l10_{key}.png is {shapes[key]}")
    emit("rene_test", tag="c25l10", image_size=list(RENE_RENDER_SIZE), files=sorted(os.listdir(out)), wall_s=wall,
         scatter_launches=0)


def phase_hotdog(fx):
    """configs/syn_hotdog_a.yaml on the MLI fixture at full width (512x512,
    dict 22), then image_test of one validation image and the metrics CLI
    against the fixture's ground truth."""
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.pipelines import metrics

    extra = _fixture_args(fx, "mli")
    trainer, fields = _train_paper_config("hotdog", HOTDOG_A, HOTDOG_LOGDIR, extra)
    del trainer
    torch.cuda.empty_cache()
    args = [*extra, "--data.val.subset=1", "--model.object.sdf.encoding.coarse2fine.enabled!"]
    t0 = time.perf_counter()
    _no_scatter("hotdog", lambda: test_cli.main(["--config", HOTDOG_A, "--logdir", HOTDOG_LOGDIR,
                                                 "--inference_mode", "image_test", *args]))
    image_test_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = metrics.main(["--config", HOTDOG_A, "--output_dir", os.path.join(HOTDOG_LOGDIR, "output_image"),
                           "--components", "rgb,ref,sha", "--allow_missing_lpips", *args])
    metrics_s = time.perf_counter() - t0
    check(sorted(scores["rgb"]) == ["mse", "psnr", "ssim"] and all(math.isfinite(v) for v in scores["rgb"].values()),
          f"hotdog: rgb scores {scores}")
    emit("hotdog", cut="coarse-to-fine off (all 16 levels live); 6 steps; 4 frames of the fixture", **fields,
         image_test_s=image_test_s, metrics_s=metrics_s, scores=scores,
         scores_note="a 6-step stage-a model: no o_r/o_s maps, so ref and sha have no prediction to score")
    return fields["scatter_launches"]


def phase_dataset_parity(fx):
    """One TINY train step on uint8 ReNe images on the card against the
    same weights and picks on the CPU: the decoded pixels bitwise equal,
    the losses within 1e-3 (relative, as stage_b_parity)."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve

    tiny = [a for a in TINY if not a.startswith(("--data.num_", "--data.train.image_size", "--data.val.image_size"))]
    cfg = Config(RENE_A, cli_args=tiny + _fixture_args(fx, "rene") + ["--data.train.image_size=[27,36]",
                                                                     "--data.val.image_size=[27,36]"])
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    check(arrays["images"].dtype == np.uint8, f"dataset_parity: images {arrays['images'].dtype}")
    rng = np.random.default_rng(0)
    img_idx = torch.from_numpy(rng.integers(0, len(arrays["images"]), (1,)))
    ray_idx = torch.from_numpy(rng.permutation(27 * 36)[:cfg.model.render.rand_rays][None])
    runs, state = {}, None
    for device in ("cpu", "cuda"):
        tr = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=os.path.join(RENE_LOGDIR + "_tiny", device),
                                                  device=device)
        if state is None:
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        tr.model.load_state_dict(state)
        dev = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
        batch = tr.gather_batch(dev, img_idx.to(device), ray_idx.to(device))
        check(dev["images"].dtype == torch.uint8 and batch["image_sampled"].dtype == torch.float32,
              f"dataset_parity: {device} arrays {dev['images'].dtype}, batch {batch['image_sampled'].dtype}")
        pixels = batch["image_sampled"].cpu()
        info = tr.train_step(batch)
        runs[device] = (pixels, {k: float(v) for k, v in info["losses"].items()}, float(info["total"]))
    (px_c, loss_c, tot_c), (px_g, loss_g, tot_g) = runs["cpu"], runs["cuda"]
    check(torch.equal(px_c, px_g), "dataset_parity: the decoded pixels differ between the card and the CPU")
    rel = {k: abs(loss_g[k] - loss_c[k]) / max(abs(loss_c[k]), 1e-30) for k in loss_c}
    rel["total"] = abs(tot_g - tot_c) / max(abs(tot_c), 1e-30)
    check(all(math.isfinite(v) for v in loss_g.values()) and max(rel.values()) <= 1e-3,
          f"dataset_parity: losses differ by {rel} (relative)")
    emit("dataset_parity", config="configs/rene_savannah_a.yaml (TINY widths, 27x36)", images_dtype="uint8",
         pixels_bitwise_equal=True, losses_cuda=loss_g, loss_rel_err=rel, tol_rel=1e-3)


def _e2e_expected(cfg):
    """Per stage-a step of a config with every hash level live: the
    scatter launches, those of them at a blocked dense level's row width
    (8F), and the encoder's table gathers. A differentiable lookup of the
    field launches one scatter per level: the stencil (shared_levels > 0)
    is one lookup, the exact path two (centre and taps), the exact-hessian
    pass one more. The sampling evaluations (no autograd) gather
    min(sampling_levels, L) levels each and scatter nothing."""
    from mlinerf_tpu_torch.models.fields import make_hashgrid_spec

    enc, grad, render = cfg.model.object.sdf.encoding, cfg.model.object.sdf.gradient, cfg.model.render
    spec = make_hashgrid_spec(enc)
    levels = enc.levels
    shared = grad.get("shared_levels") or 0
    shared = levels - 1 if shared == "auto" else min(int(shared), levels)
    lookups = (1 if shared > 0 else 2) + (shared > 0 and (grad.get("hessian") or {}).get("mode") == "exact")
    dense = sum(r ** 3 <= t for r, t in zip(spec.resolutions, spec.table_sizes))
    wide = dense * lookups if enc.hashgrid.get("dense_blocked") else 0
    sampling = render.num_sample_hierarchy * min(int(render.get("sampling_levels") or levels), levels)
    return dict(scatter=levels * lookups, scatter_wide=wide, wide_f=8 * spec.features_per_level,
                gathers=levels * lookups + sampling)


def _count_widths():
    """Wrap scatter_add_rows to count its calls by row width; returns the
    counts and a function that restores it."""
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    original = hashgrid_scatter.scatter_add_rows
    widths = {}

    def counting(idx, vals, table_size):
        widths[str(vals.shape[1])] = widths.get(str(vals.shape[1]), 0) + 1
        return original(idx, vals, table_size)

    hashgrid_scatter.scatter_add_rows = counting
    return widths, lambda: setattr(hashgrid_scatter, "scatter_add_rows", original)


def phase_e2e_parity():
    """The TINY syn_e2e_a model (auto stencil, blocked dense levels,
    sampling levels; float32 tables) on the card against the same weights
    on the CPU, one training forward and backward each: as is, with the
    corner-sampled gradient (top1cot, k=1) on uniforms handed to both, with
    the subsampled gradient, and with an occupancy grid. Each loss within
    1e-5 relative, rgb/weights/gradients within 1e-4, every gradient within
    1e-3 of its leaf's largest entry (as the parity phase)."""
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.models.neuralangelo import make_cond
    from mlinerf_tpu_torch.utils import losses

    def draw(stream, shape, device):  # the same uniforms on every device
        return torch.rand(shape, generator=torch.Generator().manual_seed(stream)).to(device)

    grid = torch.zeros(16, 16, 16)
    grid[6:10, 6:10, 6:10] = 1.0  # [-0.5, 0.5]^3: most of each ray is empty
    cases = {"e2e": ([], {}),
             "corner_sample": (E2E_VARIANTS["corner_sample"], {"corner_draw": draw}),
             "subsample": (["--model.object.sdf.gradient.subsample.enabled",
                            "--model.object.sdf.gradient.subsample.topk=6",
                            "--model.object.sdf.gradient.subsample.stride=4"], {}),
             "occupancy": (["--model.render.occupancy.enabled", "--model.render.occupancy.resolution=16"],
                           {"occupancy_grid": grid})}
    # Two dense levels (9^3 and 17^3 rows in 2^13), sampling on 2 of 4.
    tiny = [a for a in TINY if "dict_size" not in a] + ["--model.object.sdf.encoding.hashgrid.dict_size=13",
                                                        "--model.render.sampling_levels=2"]
    report = {}
    for name, (extra, cond_extra) in cases.items():
        cfg = Config(E2E_A, cli_args=tiny + extra)
        batch = _tiny_batch(cfg)
        results, state = {}, None
        for device in ("cpu", "cuda"):
            model = resolve("model", cfg.model.type)(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0))
            if state is None:
                with torch.no_grad():
                    w = model.neural_sdf.mlp.linear_0.weight
                    w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.3
                    for t in model.neural_sdf.hash_table:
                        t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
                state = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            model.to(device)
            cond = make_cond(cfg.model, 10, cfg.max_iter, cfg.optim.sched.warm_up_end)
            cond.update({k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in cond_extra.items()})
            out = model({k: v.to(device) for k, v in batch.items()}, cond, train=True)
            loss = _tiny_loss(losses, out, batch["image_sampled"].to(device))
            loss.backward()
            results[device] = dict(loss=loss.item(), out={k: out[k].detach().cpu() for k in ("rgb", "weights", "gradients")},
                                   grads={n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                                          for n, p in model.named_parameters()})
        cpu, gpu = results["cpu"], results["cuda"]
        loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        check(math.isfinite(gpu["loss"]) and loss_rel <= 1e-5, f"e2e_parity {name}: loss {gpu['loss']} vs {cpu['loss']}")
        errs = {k: float((gpu["out"][k] - cpu["out"][k]).abs().max()) for k in cpu["out"]}
        check(max(errs.values()) <= 1e-4, f"e2e_parity {name}: outputs differ by {errs}")
        worst = max(float((gpu["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                    for n, g in cpu["grads"].items())
        check(worst <= 1e-3, f"e2e_parity {name}: a gradient differs by {worst} of its leaf's max")
        check(all(float(g.abs().max()) > 0 for n, g in gpu["grads"].items() if "hash_table" in n),
              f"e2e_parity {name}: a hash table got a zero gradient on the card")
        report[name] = dict(loss_cuda=gpu["loss"], loss_rel_err=loss_rel, max_abs_err=errs,
                            worst_grad_err_rel_to_leaf_max=worst)
    emit("e2e_parity", config="configs/syn_e2e_a.yaml (TINY widths, float32 tables, dict 13, sampling_levels 2)",
         tol=dict(loss_rel=1e-5, outputs_abs=1e-4, grad_rel_to_leaf_max=1e-3), cases=report)


def _train_e2e(phase, config, logdir, extra, steps=TRAIN_STEPS, checkpoint=True):
    """``python -m mlinerf_tpu_torch.train`` in process, all hash levels
    live; checks finite losses and the scatter launches per step against
    :func:`_e2e_expected`. Returns (trainer, fields of the phase line)."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.ops import hashgrid, hashgrid_scatter

    shutil.rmtree(logdir, ignore_errors=True)
    args = ["--config", config, "--logdir", logdir, f"--max_iter={steps}", "--logging_iter=1",
            f"--checkpoint.save_iter={steps if checkpoint else 10**9}", "--model.object.sdf.encoding.coarse2fine.enabled!",
            *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    widths, restore = _count_widths()
    hashgrid_scatter.launches = 0
    hashgrid.gathers = 0
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main(args)
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches, gathers = hashgrid_scatter.launches, hashgrid.gathers
    torch.cuda.synchronize()
    cfg = trainer.cfg
    expected = _e2e_expected(cfg)
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    check([r["step"] for r in records] == list(range(1, steps + 1)), f"{phase}: missing log lines")
    check(all(math.isfinite(r["train/total_loss"]) for r in records), f"{phase}: non-finite loss")
    check(launches == expected["scatter"] * steps,
          f"{phase}: {launches} scatter_add_rows launches in {steps} steps, expected {expected['scatter']} per step")
    check(widths.get(str(expected["wide_f"]), 0) == expected["scatter_wide"] * steps,
          f"{phase}: scatter launches by row width {widths}, expected {expected['scatter_wide']} per step at "
          f"f = {expected['wide_f']}")
    check(records[-1]["train/table_grad_norm"] > 0, f"{phase}: zero hash-table gradient at the last step")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = cfg.model.render.rand_rays * cfg.data.train.batch_size
    enc = cfg.model.object.sdf.encoding
    fields = dict(config=os.path.relpath(config, HERE), extra=extra, levels=enc.levels,
                  dict_size=enc.hashgrid.dict_size, feature_dim=enc.hashgrid.dim,
                  table_dtype=enc.hashgrid.get("dtype"), coarse2fine=False,
                  shared_levels=trainer.model.shared_levels({}), dense_blocked=bool(enc.hashgrid.get("dense_blocked")),
                  sampling_levels=cfg.model.render.get("sampling_levels"), rays_per_step=rays,
                  samples_per_ray=cfg.model.render.num_samples.coarse
                  + cfg.model.render.num_samples.fine * cfg.model.render.num_sample_hierarchy,
                  steps=steps, warmup_ms=1e3 * records[0]["train/iter_time"], step_ms=step_ms, median_step_ms=ms,
                  rays_per_s=rays / (ms / 1e3), scatter_launches=launches, scatter_launches_per_step=launches / steps,
                  scatter_launches_per_step_by_row_width={f: n / steps for f, n in sorted(widths.items())},
                  gathers_per_step=gathers / steps, expected_per_step=expected,
                  loss=[r["train/total_loss"] for r in records], peak_mem_bytes=torch.cuda.max_memory_allocated(),
                  num_params=trainer.num_params, wall_s=wall)
    return trainer, fields


def phase_e2e_train(profile: bool):
    """configs/syn_e2e_a.yaml through the training CLI at full width, the
    last step saving a checkpoint; then one more step with its scatter
    launches recorded."""
    import torch
    from mlinerf_tpu_torch.config import resolve

    trainer, fields = _train_e2e("e2e_train", E2E_A, E2E_LOGDIR, [])
    check(fields["gathers_per_step"] == fields["expected_per_step"]["gathers"],
          f"e2e_train: {fields['gathers_per_step']} gathers per step, expected {fields['expected_per_step']['gathers']}")
    checkpoint = os.path.join(E2E_LOGDIR, trainer.checkpointer.checkpoint_name(trainer.current_epoch, TRAIN_STEPS))
    check(os.path.exists(checkpoint), f"e2e_train: no checkpoint of iteration {TRAIN_STEPS}")
    emit("e2e_train", cut="coarse-to-fine off (all 16 levels live); 6 steps", **fields,
         checkpoint=os.path.relpath(checkpoint, HERE), checkpoint_bytes=os.path.getsize(checkpoint))
    arrays = {k: torch.as_tensor(v, device="cuda")
              for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
    captured = capture_step(trainer, arrays)
    check(len(captured) == fields["expected_per_step"]["scatter"], f"e2e_train: {len(captured)} launches recorded")
    if profile:
        profile_kernels("e2e_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2, unit="step")
    del trainer, arrays
    torch.cuda.empty_cache()
    return fields["scatter_launches"], captured


def phase_e2e_render():
    """``--inference_mode lights_train`` from the e2e_train checkpoint: one
    camera under one light at RENDER_SIZE, light visibility on, the stencil
    in evaluation (``unpairlights`` needs 4 frames)."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.models.fields import NeuralSDF
    from mlinerf_tpu_torch.pipelines.label_store import load_results_all

    size = f"[{RENDER_SIZE},{RENDER_SIZE}]"
    args = ["--config", E2E_A, "--logdir", E2E_LOGDIR, "--inference_mode", "lights_train", "--data.num_cameras=1",
            "--data.num_lights=1", "--model.object.sdf.encoding.coarse2fine.enabled!",
            f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    stencils = []
    original = NeuralSDF.stencil

    def counting(self, *a, **kw):
        stencils.append(1)
        return original(self, *a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    NeuralSDF.stencil = counting
    t0 = time.perf_counter()
    try:
        trainer = _no_scatter("e2e_render", lambda: test_cli.main(args))
    finally:
        NeuralSDF.stencil = original
    wall = time.perf_counter() - t0
    check(trainer.current_iteration == TRAIN_STEPS, f"e2e_render: checkpoint at iteration {trainer.current_iteration}")
    check(len(stencils) > 0, "e2e_render: the stencil did not run in evaluation")
    results = load_results_all(os.path.join(E2E_LOGDIR, "output_lights_train", "results_all"))
    maps = [m for c in results.values() for m in c.values()]
    check(len(maps) == 1 and all(m[k].shape[:3] == (1, RENDER_SIZE, RENDER_SIZE) and np.isfinite(m[k]).all()
                                 for m in maps for k in m), "e2e_render: results_all lacks the render or has a bad map")
    emit("e2e_render", config="configs/syn_e2e_a.yaml", mode="lights_train (1 camera x 1 light)",
         image_size=[RENDER_SIZE, RENDER_SIZE], wall_s=wall, rays_per_s_wall=RENDER_SIZE ** 2 / wall,
         stencil_calls=len(stencils), scatter_launches=0, peak_mem_bytes=torch.cuda.max_memory_allocated())
    del trainer
    torch.cuda.empty_cache()


def phase_e2e_train_b():
    """configs/syn_e2e_b.yaml through the training CLI, warm-started from
    e2e_train, on the pseudo_label phase's labels (2 cameras x 2 lights at
    RENDER_SIZE): the SDF unchanged, 0 scatter launches."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer

    stage_a = os.path.join(E2E_LOGDIR, "latest_checkpoint.txt")
    shutil.rmtree(E2E_LOGDIR_B, ignore_errors=True)
    size = f"[{RENDER_SIZE},{RENDER_SIZE}]"
    args = ["--config", E2E_B, "--logdir", E2E_LOGDIR_B, f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
            "--data.num_cameras=2", "--data.num_lights=2", f"--data.train.image_size={size}",
            f"--data.val.image_size={size}", f"--model.use_pre_trained.pt_filename={stage_a}",
            f"--data.train.pseudo_label.pt_file={RENDERS}_pseudo_label/pseudo_label_all.npz"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = _no_scatter("e2e_train_b", lambda: train_cli.main(args))
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in open(os.path.join(E2E_LOGDIR_B, "metrics.jsonl"))]
    keys = ("render", "eikonal", "curvature", "intrinsic", "regularize_re")
    check(all(math.isfinite(r[f"train/loss/{k}"]) for r in records for k in keys), "e2e_train_b: a loss is not finite")
    before = Checkpointer.load_file(stage_a)["state"]["params"]
    after = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    sdf = [k for k in after if k.startswith("neural_sdf.")]
    check(all(torch.equal(after[k], before[k]) for k in sdf), "e2e_train_b: a neural_sdf parameter changed")
    moved = [k for k in after if k.startswith("neural_rgb.") and (k not in before or not torch.equal(after[k], before[k]))]
    check(bool(moved), "e2e_train_b: the heads did not move")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = trainer.cfg.model.render.rand_rays * trainer.cfg.data.train.batch_size
    emit("e2e_train_b", config="configs/syn_e2e_b.yaml", labels="the pseudo_label phase's (syn_prodscale chain)",
         image_size=[RENDER_SIZE, RENDER_SIZE], steps=TRAIN_STEPS, step_ms=step_ms, median_step_ms=ms,
         rays_per_s=rays / (ms / 1e3), scatter_launches=0, losses={k: [r[f"train/loss/{k}"] for r in records]
                                                                   for k in keys},
         sdf_leaves_bitwise_equal=len(sdf), head_leaves_moved=len(moved),
         peak_mem_bytes=torch.cuda.max_memory_allocated(), wall_s=wall)
    del trainer
    torch.cuda.empty_cache()


def phase_variants():
    """syn_e2e_a at full width with each opt-in knob on, one at a time,
    1 + 5 steps each: the step time and the launch counts."""
    import torch

    report, total = {}, 0
    logdir = os.path.join(HERE, "logs", "chip_smoke_variant")
    for name, extra in E2E_VARIANTS.items():
        trainer, fields = _train_e2e(f"variants {name}", E2E_A, logdir, extra, checkpoint=False)
        if name == "occupancy":
            grid = trainer.occupancy_grid
            check(grid is not None and trainer._occupancy_iter == TRAIN_STEPS - 2,
                  f"variants occupancy: the grid was last refreshed at {trainer._occupancy_iter}")
            fields["occupied_share"] = float(grid.mean())
        report[name] = {k: fields[k] for k in ("extra", "median_step_ms", "rays_per_s", "step_ms",
                                                "scatter_launches_per_step", "scatter_launches_per_step_by_row_width",
                                                "gathers_per_step", "peak_mem_bytes", "wall_s")}
        report[name].update({k: fields[k] for k in ("occupied_share",) if k in fields})
        total += fields["scatter_launches"]
        del trainer
        torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    emit("variants", config="configs/syn_e2e_a.yaml", cut="coarse-to-fine off (all 16 levels live); 6 steps each",
         variants=report)
    return total


# ---------------------------------------------------------------------------
# The substrate families: vanilla NeRF and Instant-NGP on the nerf_blender
# and nerf_llff layouts
# ---------------------------------------------------------------------------

NERF_TINY = ["--model.mlp.layers_feat=[null,32,32,32]", "--model.mlp.layers_rgb=[null,32,3]", "--model.mlp.skip=[2]",
             "--model.posenc.L_3D=4", "--model.posenc.L_view=2", "--model.rand_rays=64", "--model.sample_intvs=16",
             "--model.sample_intvs_fine=16", "--model.sample_stratified!", "--data.train.image_size=[16,16]",
             "--data.val.image_size=[16,16]"]
INGP_TINY = ["--model.mlp.layers_feat=[null,32,32]", "--model.mlp.layers_rgb=[null,32,3]", "--model.posenc.L_view=2",
             "--model.rand_rays=64", "--model.sample_intvs=16", "--model.sample_stratified!",
             "--model.posenc.hashgrid.levels=4", "--model.posenc.hashgrid.min_logres=2",
             "--model.posenc.hashgrid.max_logres=6", "--model.posenc.hashgrid.dict_size=12",
             "--model.posenc.hashgrid.range=[-2,2]", "--data.train.image_size=[16,16]",
             "--data.val.image_size=[16,16]"]
# Card against CPU: float32 as the parity phase; bf16 as the tests hold
# the port's bf16 weights against the JAX package (cuBLAS's and the CPU's
# bf16 GEMMs round their products differently, and the rounding carries
# through 3-4 bf16 layers).
NERF_PARITY_TOL = {"float32": dict(loss_rel=1e-5, outputs_abs=1e-4, grad_rel_to_leaf_max=1e-3),
                   "bfloat16": dict(loss_rel=1e-4, outputs_abs=1e-3, grad_rel_to_leaf_max=2e-2)}
NERF_BLENDER = os.path.join(HERE, "configs", "nerf_blender.yaml")
INGP_BLENDER = os.path.join(HERE, "configs", "ingp_blender.yaml")
NERF_LLFF = os.path.join(HERE, "configs", "nerf_llff.yaml")
NERF_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_nerf")
INGP_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_ingp")
LLFF_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_llff")
NERF_FRAMES = (4, 2)  # train and val frames of the NeRF-synthetic stand-in (lego: 100, 100)
LLFF_FRAMES = 9  # views of the LLFF stand-in: 7 train, 2 val (fern: 20)


def phase_nerf_parity():
    """TINY nerf (coarse + fine, float32 and bf16) and TINY ingp (float32
    and bf16) on the card against the same weights and rays on the CPU:
    one forward and backward of the NeRF trainer's MSE loss; the loss, every
    output and every parameter's gradient within NERF_PARITY_TOL."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.data.synthetic import look_at_pose
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    pose = torch.from_numpy(look_at_pose(np.asarray([0.5, -3.9, 1.0], np.float32)).astype(np.float32))[None]
    intr = torch.tensor([[[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]])
    rng = np.random.default_rng(0)
    batch = dict(pose=pose, intr=intr, ray_idx=torch.from_numpy(rng.permutation(256)[:64][None]),
                 image_sampled=torch.from_numpy(rng.uniform(0, 1, (1, 64, 3)).astype(np.float32)))
    report = {}
    for name, config, tiny in (("nerf", NERF_BLENDER, NERF_TINY), ("ingp", INGP_BLENDER, INGP_TINY)):
        cfg = Config(config, cli_args=tiny)
        for dtype in (torch.float32, torch.bfloat16):
            results, state = {}, None
            for device in ("cpu", "cuda"):
                model = resolve("model", cfg.model.type)(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0),
                                                         compute_dtype=dtype)
                if state is None:
                    with torch.no_grad():
                        for t in getattr(model.nerf, "hash_table", []):
                            t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
                    state = {k: v.clone() for k, v in model.state_dict().items()}
                model.load_state_dict(state)
                model.to(device)
                before = hashgrid_scatter.launches
                out = model({k: v.to(device) for k, v in batch.items()}, train=True)
                target = batch["image_sampled"].to(device)
                loss = sum(torch.mean((out[k] - target) ** 2) for k in ("rgb", "rgb_fine") if k in out)
                loss.backward()
                torch.cuda.synchronize()
                results[device] = dict(loss=loss.item(), out={k: v.detach().cpu() for k, v in out.items()},
                                       grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                                       launches=hashgrid_scatter.launches - before)
            cpu, gpu = results["cpu"], results["cuda"]
            key = str(dtype).replace("torch.", "")
            tol = NERF_PARITY_TOL[key]
            levels = cfg.model.posenc.hashgrid.levels if name == "ingp" else 0
            check(cpu["launches"] == 0 and gpu["launches"] == levels,
                  f"nerf_parity {name} {key}: {gpu['launches']} scatter launches on the card, expected {levels}")
            loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
            check(math.isfinite(gpu["loss"]) and loss_rel <= tol["loss_rel"],
                  f"nerf_parity {name} {key}: loss {gpu['loss']} vs {cpu['loss']}")
            errs = {k: float((gpu["out"][k] - cpu["out"][k]).abs().max()) for k in cpu["out"]}
            check(max(errs.values()) <= tol["outputs_abs"], f"nerf_parity {name} {key}: outputs differ by {errs}")
            worst = {n: float((gpu["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                     for n, g in cpu["grads"].items()}
            check(max(worst.values()) <= tol["grad_rel_to_leaf_max"],
                  f"nerf_parity {name} {key}: gradients differ by {max(worst.values())} of the leaf max "
                  f"({max(worst, key=worst.get)})")
            report[f"{name}_{key}"] = dict(loss_cuda=gpu["loss"], loss_rel_err=loss_rel, max_abs_err=errs,
                                           worst_grad_err_rel_to_leaf_max=max(worst.values()),
                                           worst_grad_leaf=max(worst, key=worst.get), scatter_launches=gpu["launches"])
    emit("nerf_parity", configs=["configs/nerf_blender.yaml (TINY: 3x32 MLP, L4/L2, 64 rays at 16 + 16 samples)",
                                 "configs/ingp_blender.yaml (TINY: L4 F4 dict 12, 2x32 MLP, 16 samples)"],
         tol=NERF_PARITY_TOL, cases=report)


def phase_nerf_fixtures(tmp):
    """The NeRF-synthetic stand-in in lego's layout (RGBA 800x800 frames,
    transforms_{train,val}.json) and the LLFF one in fern's (poses_bounds.npy
    and 1008x756 PNG frames), in a temporary directory."""
    from mlinerf_tpu_torch.data import fixtures

    t0 = time.perf_counter()
    lego = os.path.join(tmp, "nerf_synthetic_lego")
    fixtures.write_nerf_synthetic(lego, image_size=800, train=NERF_FRAMES[0], val=NERF_FRAMES[1],
                                  save=fixtures.filtered_saver(2), seed=2)
    lego_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fern = fixtures.write_llff(os.path.join(tmp, "nerf_llff_fern"), raw_size=(1008, 756), frames=LLFF_FRAMES,
                               save=fixtures.filtered_saver(3), seed=3)
    fern_s = time.perf_counter() - t0
    emit("nerf_fixtures", nerf_synthetic=dict(root="<tmp>/nerf_synthetic_lego", raw_size=[800, 800], channels=4,
                                              frames=dict(train=NERF_FRAMES[0], val=NERF_FRAMES[1]), write_s=lego_s),
         llff=dict(root="<tmp>/nerf_llff_fern", raw_size=[1008, 756], frames=LLFF_FRAMES, val_ratio=8,
                   format="PNG (fern's frames are JPEG, which the port does not decode)", write_s=fern_s))
    return {"lego": lego, "fern": fern}


def _train_nerf(phase, config, logdir, root):
    """``python -m mlinerf_tpu_torch.train`` in process on a stand-in, the
    config as shipped, TRAIN_STEPS steps, the last saving a checkpoint;
    checks uint8 images on the card, bf16 MLPs (amp_config), finite losses
    and the scatter launches per step: one per hash level (ingp), none
    (nerf). Returns (trainer, fields)."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    shutil.rmtree(logdir, ignore_errors=True)
    args = ["--config", config, "--logdir", logdir, f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
            f"--checkpoint.save_iter={TRAIN_STEPS}", f"--data.root={root}"]
    probe = {}
    restore = _device_arrays_probe(probe)
    widths, restore_widths = _count_widths()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main(args)
    finally:
        restore()
        restore_widths()
    wall = time.perf_counter() - t0
    launches = hashgrid_scatter.launches
    torch.cuda.synchronize()
    cfg = trainer.cfg
    check(probe["images"][:2] == ("torch.uint8", "cuda:0"), f"{phase}: images on the card as {probe['images'][:2]}")
    check(trainer.compute_dtype == torch.bfloat16, f"{phase}: MLPs in {trainer.compute_dtype}, amp_config asks bf16")
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    check([r["step"] for r in records] == list(range(1, TRAIN_STEPS + 1)), f"{phase}: missing log lines")
    losses = ["render"] + (["render_fine"] if cfg.model.fine_sampling else [])
    check(all(math.isfinite(r[f"train/loss/{k}"]) for r in records for k in losses), f"{phase}: non-finite loss")
    expected = cfg.model.posenc.hashgrid.levels if cfg.model.type == "ingp" else 0
    check(launches == expected * TRAIN_STEPS,
          f"{phase}: {launches} scatter_add_rows launches in {TRAIN_STEPS} steps, expected {expected} per step")
    checkpoint = os.path.join(logdir, trainer.checkpointer.checkpoint_name(trainer.current_epoch, TRAIN_STEPS))
    check(os.path.exists(checkpoint), f"{phase}: no checkpoint of iteration {TRAIN_STEPS}")
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    ms = statistics.median(step_ms)
    rays = cfg.model.rand_rays * cfg.data.train.batch_size
    samples = cfg.model.sample_intvs + (cfg.model.sample_intvs_fine if cfg.model.fine_sampling else 0)
    fields = dict(config=os.path.relpath(config, HERE), image_size=list(cfg.data.train.image_size),
                  frames=probe["pose"][2] // (12 * 4), compute_dtype="bfloat16", optimizer=cfg.optim.type,
                  rays_per_step=rays, samples_per_ray=samples, steps=TRAIN_STEPS,
                  warmup_ms=1e3 * records[0]["train/iter_time"], step_ms=step_ms, median_step_ms=ms,
                  rays_per_s=rays / (ms / 1e3), samples_per_s=rays * samples / (ms / 1e3),
                  scatter_launches=launches, scatter_launches_per_step=launches / TRAIN_STEPS,
                  scatter_launches_by_row_width=widths, loss={k: [r[f"train/loss/{k}"] for r in records] for k in losses},
                  psnr=[r["train/psnr"] for r in records], table_grad_norm=[r["train/table_grad_norm"] for r in records],
                  lr=[r["optim/lr"] for r in records], peak_mem_bytes=torch.cuda.max_memory_allocated(),
                  num_params=trainer.num_params, checkpoint=os.path.relpath(checkpoint, HERE),
                  checkpoint_bytes=os.path.getsize(checkpoint), wall_s=wall)
    return trainer, fields


def phase_nerf_train(fx, profile: bool):
    """configs/nerf_blender.yaml as shipped (8x256 MLP with a skip at 4,
    L10/L4, 2 x 1024 rays at 64 + 128 samples, bf16, Adam, 400x400) through
    the training CLI on the NeRF-synthetic stand-in: no scatter."""
    import torch
    from mlinerf_tpu_torch.config import resolve

    trainer, fields = _train_nerf("nerf_train", NERF_BLENDER, NERF_LOGDIR, fx["lego"])
    emit("nerf_train", cut=f"6 steps; {NERF_FRAMES[0]} train frames of the stand-in", **fields)
    if profile:
        arrays = {k: torch.as_tensor(v, device="cuda")
                  for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
        profile_kernels("nerf_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2, unit="step")
    del trainer
    torch.cuda.empty_cache()


def phase_ingp_train(fx, profile: bool):
    """configs/ingp_blender.yaml as shipped (L16 F4, dict 19, range [-5, 5],
    float32 tables, 64-wide MLPs, 2 x 1024 rays at 256 samples, bf16 MLPs)
    through the training CLI on the NeRF-synthetic stand-in: exactly one
    scatter launch per level per step, all at F = 4; then one more step
    with its launches recorded."""
    import torch
    from mlinerf_tpu_torch.config import resolve

    trainer, fields = _train_nerf("ingp_train", INGP_BLENDER, INGP_LOGDIR, fx["lego"])
    levels = trainer.cfg.model.posenc.hashgrid.levels
    check(levels == 16 and fields["scatter_launches_by_row_width"] == {"4": 16 * TRAIN_STEPS},
          f"ingp_train: launches by row width {fields['scatter_launches_by_row_width']}")
    check(fields["table_grad_norm"][-1] > 0, "ingp_train: zero hash-table gradient at the last step")
    tables = [p for n, p in trainer.model.named_parameters() if ".hash_table." in n]
    check({t.dtype for t in tables} == {torch.float32}, "ingp_train: the tables are not float32")
    emit("ingp_train", cut=f"6 steps; {NERF_FRAMES[0]} train frames of the stand-in", levels=levels,
         table_rows=[t.shape[0] for t in tables], table_dtype="float32", **fields)
    arrays = {k: torch.as_tensor(v, device="cuda")
              for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
    captured = capture_step(trainer, arrays)
    check(len(captured) == levels and all(v.shape[1] == 4 and v.dtype == torch.float32 for _, v, _ in captured),
          f"ingp_train: {len(captured)} launches recorded in one step")
    if profile:
        profile_kernels("ingp_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2, unit="step")
    del trainer, arrays
    torch.cuda.empty_cache()
    return fields["scatter_launches"], captured


def phase_llff_train(fx):
    """configs/nerf_llff.yaml as shipped (NDC rays, 1 x 1024 rays at 64 +
    128 samples, 378x504) through the training CLI on the LLFF stand-in:
    no scatter."""
    import torch

    trainer, fields = _train_nerf("llff_train", NERF_LLFF, LLFF_LOGDIR, fx["fern"])
    check(trainer.cfg.model.camera_ndc and fields["frames"] == LLFF_FRAMES - 2,
          f"llff_train: {fields['frames']} train frames, camera_ndc {trainer.cfg.model.camera_ndc}")
    emit("llff_train", cut=f"6 steps; {LLFF_FRAMES} views of the stand-in (PNG)", camera_ndc=True, **fields)
    del trainer
    torch.cuda.empty_cache()


def phase_nerf_render(fx):
    """``python -m mlinerf_tpu_torch.test --inference_mode image_test`` of
    one 400x400 validation frame from the nerf_train and ingp_train
    checkpoints: the render's rays/s (render_image calls, each to its host
    copy) and 0 scatter launches."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.utils.image_io import read_png

    report = {}
    for name, config, logdir in (("nerf", NERF_BLENDER, NERF_LOGDIR), ("ingp", INGP_BLENDER, INGP_LOGDIR)):
        args = ["--config", config, "--logdir", logdir, "--inference_mode", "image_test", f"--data.root={fx['lego']}",
                "--data.val.subset=1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        renders, restore = _timed_renders()
        t0 = time.perf_counter()
        try:
            trainer = _no_scatter(f"nerf_render {name}", lambda: test_cli.main(args))
        finally:
            restore()
        wall = time.perf_counter() - t0
        check(trainer.current_iteration == TRAIN_STEPS and len(renders) == 1,
              f"nerf_render {name}: iteration {trainer.current_iteration}, {len(renders)} renders")
        H, W = trainer.cfg.data.val.image_size
        out = os.path.join(logdir, "output_image")
        maps = {k: read_png(os.path.join(out, f"0_{k}.png")) for k in ("rgb_map", "depth_map", "opacity_map", "gt")}
        check(all(m.shape[:2] == (H, W) for m in maps.values()), f"nerf_render {name}: map shapes "
                                                                 f"{ {k: m.shape for k, m in maps.items()} }")
        check(float(np.std(maps["rgb_map"])) > 0, f"nerf_render {name}: a constant rgb map")
        render_s, rays = renders[0]
        report[name] = dict(config=os.path.relpath(config, HERE), image_size=[H, W], rays=rays,
                            chunk_rays=trainer.num_val_rays(), render_s=render_s, rays_per_s=rays / render_s,
                            wall_s=wall, scatter_launches=0, peak_mem_bytes=torch.cuda.max_memory_allocated())
        del trainer
        torch.cuda.empty_cache()
    emit("nerf_render", mode="image_test (1 validation frame)", renders=report)


# The Neuralangelo family's own branches: the neuralangelo model with the
# background NeRF and appearance embeddings, analytical SDF gradients; and
# the relighting video on the ReNe chain.
ANGELO_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_angelo")
ANALYTICAL_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_analytical")
ANGELO_ARGS = ["--model.type=neuralangelo", "--trainer.type=neuralangelo", "--model.background.enabled=True",
               "--model.appear_embed.enabled=True"]
ANALYTICAL_ARGS = ["--model.object.sdf.gradient.mode=analytical"]
# The TINY background (4 x 32, L4, 8 samples) and embeddings (dim 4) of
# tests/test_torch_background.py.
ANGELO_TINY = ANGELO_ARGS + ["--model.background.white=False", "--model.background.mlp.hidden_dim=32",
                             "--model.background.mlp.hidden_dim_rgb=16", "--model.background.mlp.num_layers=4",
                             "--model.background.mlp.skip=[2]", "--model.background.encoding.levels=4",
                             "--model.render.num_samples.background=8", "--model.appear_embed.dim=4",
                             "--data.num_images=4"]
# test_video's frames (the JAX package's 60), cut for the run's time limit.
VIDEO_FRAMES = 4


# Card against CPU in float32: outputs within 1e-4, the Hessian within 1e-4
# of its largest entry inside the bounds, every gradient within 1e-3 of its
# leaf's largest entry.
F32_TOL = dict(outputs=1e-4, normals=1e-4, weights=1e-4, hessians_rel=1e-4, grad_rel=1e-3, bias_grad_rel=1e-3,
               table_grad_rel=1e-3)
# Under bf16 MLPs, the bounds of tests/test_torch_amp.py (the port against
# the JAX package): an SDF value that the two round a bf16 ulp apart is
# amplified by the numerical gradient's differences.
AMP_TOL = dict(outputs=1e-3, normals=0.1, weights=0.04, hessians_rel=0.25, grad_rel=0.02, bias_grad_rel=0.25,
               table_grad_rel=0.15)


def _card_vs_cpu_step(cfg, phase, compute_dtype="float32", tol=None):
    """One training forward and backward of _tiny_loss through the config's
    model (MLPs in ``compute_dtype``) on the CPU and on the card, from the
    same state (the SDF's encoding columns opened and the tables drawn
    U(-0.1, 0.1), so the tables get gradient), held within ``tol``
    (F32_TOL by default). Returns the errors and the card's scatter
    launches."""
    import torch
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.models.neuralangelo import make_cond
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.utils import losses

    tol = tol or F32_TOL
    batch = _tiny_batch(cfg)
    cond = make_cond(cfg.model, 10, cfg.max_iter, cfg.optim.sched.warm_up_end)
    results, state = {}, None
    for device in ("cpu", "cuda"):
        model = resolve("model", cfg.model.type)(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0),
                                                 compute_dtype=getattr(torch, compute_dtype))
        if state is None:
            with torch.no_grad():
                w = model.neural_sdf.mlp.linear_0.weight
                w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.3
                for t in model.neural_sdf.hash_table:
                    t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        model.to(device)
        before = hashgrid_scatter.launches
        out = model({k: v.to(device) for k, v in batch.items()}, cond, train=True)
        loss = _tiny_loss(losses, out, batch["image_sampled"].to(device))
        loss.backward()
        torch.cuda.synchronize()
        results[device] = dict(loss=loss.item(), launches=hashgrid_scatter.launches - before,
                               out={k: out[k].detach().cpu() for k in ("rgb", "weights", "gradients", "hessians",
                                                                      "outside")},
                               grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    cpu, gpu = results["cpu"], results["cuda"]
    errs = {}
    for k, bound in (("rgb", tol["outputs"]), ("weights", tol["weights"]), ("gradients", tol["normals"])):
        check(bool(torch.isfinite(gpu["out"][k]).all()), f"{phase}: non-finite {k} on the card")
        errs[k] = float((gpu["out"][k] - cpu["out"][k]).abs().max())
        check(errs[k] <= bound, f"{phase}: {k} differs by {errs[k]} between the card and the CPU")
    inside = ~cpu["out"]["outside"][..., 0]
    hess = cpu["out"]["hessians"][inside]
    errs["hessians_rel_to_max"] = float((gpu["out"]["hessians"][inside] - hess).abs().max() / hess.abs().max())
    check(errs["hessians_rel_to_max"] <= tol["hessians_rel"],
          f"{phase}: hessians differ by {errs['hessians_rel_to_max']} of their max")
    worst = {n: float((gpu["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
             for n, g in cpu["grads"].items()}
    for n, err in worst.items():
        bound = (tol["table_grad_rel"] if ".hash_table." in n else tol["bias_grad_rel"] if n.endswith(".bias")
                 else tol["grad_rel"])
        check(err <= bound, f"{phase}: grad of {n} differs by {err} of its max between the card and the CPU")
    check(all(float(g.abs().max()) > 0 for n, g in gpu["grads"].items() if "hash_table" in n),
          f"{phase}: a hash table got a zero gradient on the card")
    check(cpu["launches"] == 0, f"{phase}: {cpu['launches']} scatter launches on the CPU")
    return dict(loss_cpu=cpu["loss"], loss_cuda=gpu["loss"], max_abs_err=errs,
                worst_grad_err_rel_to_leaf_max=max(worst.values()), worst_grad_leaf=max(worst, key=worst.get),
                scatter_launches_cuda=gpu["launches"], params=len(worst))


def phase_angelo_parity():
    """The TINY neuralangelo model with the background and embeddings on,
    and the TINY Lumen model in the analytical mode, each one training
    forward and backward on the card against the same weights on the
    CPU: outputs within 1e-4, the Hessian within 1e-4 of its largest entry,
    every gradient within 1e-3 of its leaf's largest entry; the scatter
    launches on the card (2 per level numerically, 1 analytically)."""
    from mlinerf_tpu_torch.config import Config

    report = {}
    for name, extra, per_level in (("neuralangelo", ANGELO_TINY, 2), ("analytical", ANALYTICAL_ARGS, 1)):
        cfg = Config(os.path.join(HERE, "configs", "syn_sphere_a.yaml"), cli_args=TINY + extra)
        report[name] = _card_vs_cpu_step(cfg, f"angelo_parity {name}")
        levels = cfg.model.object.sdf.encoding.levels
        check(report[name]["scatter_launches_cuda"] == per_level * levels,
              f"angelo_parity {name}: {report[name]['scatter_launches_cuda']} scatter launches on the card, "
              f"expected {per_level * levels}")
    emit("angelo_parity", configs={"neuralangelo": "syn_sphere_a TINY + " + " ".join(ANGELO_TINY),
                                   "analytical": "syn_sphere_a TINY + " + " ".join(ANALYTICAL_ARGS)},
         tol=dict(outputs_abs=1e-4, hessians_rel_to_max=1e-4, grad_rel_to_leaf_max=1e-3), cases=report)


def phase_angelo_train(profile: bool):
    """configs/syn_prodscale_a.yaml as the neuralangelo model with the
    background NeRF at base_sdf.yaml's widths (8 x 256 with a skip at 4, 2 x
    128 for rgb, Fourier L10, SH 3 view, 32 samples) and appearance
    embeddings (dim 8) over the dataset's frames, through the training CLI:
    1 + 5 steps and a checkpoint with the JAX package's leaf names."""
    import torch
    from mlinerf_tpu_torch.config import Config
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer

    base = Config(PRODSCALE)
    frames = base.data.num_cameras * base.data.num_lights
    extra = ANGELO_ARGS + [f"--data.num_images={frames}"]
    trainer, fields = _train_paper_config("angelo_train", PRODSCALE, ANGELO_LOGDIR, extra, images_dtype="torch.float32")
    cfg = trainer.cfg
    check(fields["frames"] == frames, f"angelo_train: {fields['frames']} frames, data.num_images {frames}")
    params = Checkpointer.load_file(os.path.join(ANGELO_LOGDIR, "latest_checkpoint.txt"))["state"]["params"]
    leaves = ("background_nerf.mlp_feat.linear_0.weight", "background_nerf.mlp_rgb.linear_0.weight",
              "appear_embed.weight", "appear_embed_outside.weight")
    check(all(k in params for k in leaves), f"angelo_train: checkpoint leaves {sorted(params)[:8]}")
    check(tuple(params["appear_embed.weight"].shape) == (frames, cfg.model.appear_embed.dim),
          f"angelo_train: appear_embed {tuple(params['appear_embed.weight'].shape)}")
    bg = cfg.model.background
    emit("angelo_train", cut="6 steps; coarse-to-fine off (all 16 levels live)", overrides=extra,
         background=dict(layers=bg.mlp.num_layers, width=bg.mlp.hidden_dim, skip=list(bg.mlp.skip),
                         rgb_layers=bg.mlp.num_layers_rgb, rgb_width=bg.mlp.hidden_dim_rgb,
                         encoding=f"{bg.encoding.type} L{bg.encoding.levels}",
                         view=f"{bg.encoding_view.type} {bg.encoding_view.levels}",
                         samples=cfg.model.render.num_samples.background, white=bg.white),
         appear_embed_dim=cfg.model.appear_embed.dim, num_images=frames, **fields)
    if profile:
        arrays = {k: torch.as_tensor(v, device="cuda")
                  for k, v in resolve("dataset", cfg.data.type)(cfg).as_arrays().items()}
        profile_kernels("angelo_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2, unit="step")
    del trainer
    torch.cuda.empty_cache()
    return fields["scatter_launches"]


def phase_analytical_train(profile: bool):
    """configs/syn_prodscale_a.yaml with ``gradient.mode: analytical`` (1024
    rays at 64 + 16 x 4 samples) through the training CLI: 1 + 5 steps, one
    scatter launch per level per step (each level's single lookup takes
    the cotangent of the loss through the field, its gradient and its
    Hessian), peak memory; then one more step with its launches recorded."""
    import torch
    from mlinerf_tpu_torch.config import resolve

    trainer, fields = _train_paper_config("analytical_train", PRODSCALE, ANALYTICAL_LOGDIR, ANALYTICAL_ARGS,
                                          images_dtype="torch.float32", scatters_per_level=1)
    emit("analytical_train", cut="6 steps; coarse-to-fine off (all 16 levels live)", overrides=ANALYTICAL_ARGS,
         checkpointing="none (torch.utils.checkpoint not used)", **fields)
    arrays = {k: torch.as_tensor(v, device="cuda")
              for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
    captured = capture_step(trainer, arrays)
    check(len(captured) == trainer.cfg.model.object.sdf.encoding.levels,
          f"analytical_train: {len(captured)} launches recorded in one step")
    if profile:
        profile_kernels("analytical_profile", lambda: trainer.train_step(trainer.sample_batch(arrays)), reps=2,
                        unit="step")
    del trainer, arrays
    torch.cuda.empty_cache()
    return fields["scatter_launches"], captured


def phase_angelo_render():
    """``python -m mlinerf_tpu_torch.test --inference_mode image_test`` of
    one 256x256 validation frame from the angelo_train checkpoint (the
    background composited, the zero appearance embedding): rays/s, 0
    scatter launches."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.config import Config
    from mlinerf_tpu_torch.utils.image_io import read_png

    base = Config(PRODSCALE)
    args = ["--config", PRODSCALE, "--logdir", ANGELO_LOGDIR, "--inference_mode", "image_test", *ANGELO_ARGS,
            f"--data.num_images={base.data.num_cameras * base.data.num_lights}", "--data.val.subset=1",
            "--model.object.sdf.encoding.coarse2fine.enabled!"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    renders, restore = _timed_renders()
    try:
        trainer = _no_scatter("angelo_render", lambda: test_cli.main(args))
    finally:
        restore()
    check(trainer.current_iteration == TRAIN_STEPS and len(renders) == 1,
          f"angelo_render: iteration {trainer.current_iteration}, {len(renders)} renders")
    H, W = trainer.cfg.data.val.image_size
    out = os.path.join(ANGELO_LOGDIR, "output_image")
    maps = {k: read_png(os.path.join(out, f"0_{k}.png")) for k in ("rgb_map", "normal_map", "depth_map", "gt")}
    check(all(m.shape[:2] == (H, W) for m in maps.values()) and float(np.std(maps["rgb_map"])) > 0,
          f"angelo_render: maps { {k: m.shape for k, m in maps.items()} }")
    render_s, rays = renders[0]
    emit("angelo_render", mode="image_test (1 validation frame)", image_size=[H, W], rays=rays,
         chunk_rays=trainer.num_val_rays(), render_s=render_s, rays_per_s=rays / render_s, scatter_launches=0,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    del trainer
    torch.cuda.empty_cache()


def phase_video(fx):
    """``--inference_mode video_train_0_3`` from the rene_train_b checkpoint
    (camera and light slerped from frame 0 to frame 3 of the render's
    frames, 270x360): the rgb, gt, o_r, o_s and o_re tiles (rgb_r_s) of
    VIDEO_FRAMES frames (test_video's 60 cut), read back from the APNG; 0
    scatter launches."""
    import functools
    from mlinerf_tpu_torch import test as test_cli
    from mlinerf_tpu_torch.pipelines import inference
    from mlinerf_tpu_torch.utils.image_io import read_apng

    size = f"[{RENE_RENDER_SIZE[0]},{RENE_RENDER_SIZE[1]}]"
    args = ["--config", RENE_B, "--logdir", RENE_LOGDIR_B, "--inference_mode", "video_train_0_3",
            *_fixture_args(fx, "rene", "render"), f"--data.train.image_size={size}", f"--data.val.image_size={size}"]
    original = inference.test_video
    inference.test_video = functools.partial(original, num_frames=VIDEO_FRAMES)
    renders, restore = _timed_renders()
    t0 = time.perf_counter()
    try:
        _no_scatter("video", lambda: test_cli.main(args))
    finally:
        inference.test_video = original
        restore()
    wall = time.perf_counter() - t0
    path = os.path.join(RENE_LOGDIR_B, "output_video_train", "video_0_3.apng")
    frames, delays = read_apng(path)
    tile = (RENE_RENDER_SIZE[0] + RENE_RENDER_SIZE[0] // 10, RENE_RENDER_SIZE[1])
    rows, cols = 2, 3  # 5 tiles: rgb, gt, o_r, o_s, o_re
    shape = (rows * tile[0], cols * tile[1] + 5 * (cols - 1), 3)
    check(len(frames) == 2 * VIDEO_FRAMES and all(f.shape == shape for f in frames),
          f"video: {len(frames)} frames of {frames[0].shape}, expected {2 * VIDEO_FRAMES} of {shape}")
    check(all((f[:RENE_RENDER_SIZE[0], :RENE_RENDER_SIZE[1]] != frames[0][:RENE_RENDER_SIZE[0], :RENE_RENDER_SIZE[1]])
              .any() for f in frames[1:VIDEO_FRAMES]), "video: the rgb tile does not move along the path")
    emit("video", mode="video_train_0_3", cut=f"{VIDEO_FRAMES} frames (test_video's 60)", frames=len(frames),
         tiles=["rgb", "gt", "o_r", "o_s", "o_re"],
         frame_shape=list(shape), delay_s=delays[0], apng_bytes=os.path.getsize(path), wall_s=wall,
         render_s=[r[0] for r in renders], scatter_launches=0)


# ---------------------------------------------------------------------------
# Data-parallel training (parallel/distributed.py) and the runtime options
# ---------------------------------------------------------------------------

DDP_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_ddp")
DDP2_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_ddp2")
DDP2_STEPS = 4  # 1 warm-up + 3 measured
STAGE_B_TINY = ["--model.use_pre_trained=", "--data.train.pseudo_label.enabled!", "--optim.sched.warm_up_end=0"]
DDP_TABLES = ["--model.object.sdf.encoding.hashgrid.dict_size=13"]  # 8192 rows: tables to shard


def _override(args, extra):
    """``args`` with ``extra``; an override of ``extra`` replaces one of the
    same key in ``args``."""
    def key(arg):
        return arg.split("=")[0].rstrip("!")

    keys = {key(a) for a in extra}
    return [a for a in args if key(a) not in keys] + list(extra)


def _rank_entry(rank, world, workdir, task, payload):
    """One rank of a phase's spawned group: gloo on cuda:0 through a
    FileStore in ``workdir`` (NCCL refuses two ranks on one card); runs
    ``task`` and saves its result as <workdir>/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world), rank=rank,
                            world_size=world)
    try:
        torch.save(globals()[task](rank, payload), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(world, task, payload, timeout=300):
    """``world`` ranks of ``task`` (spawned processes); every rank must exit
    0 within ``timeout`` (a rank still alive then is killed). Returns their
    results in rank order."""
    import multiprocessing
    import torch

    workdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    procs = [multiprocessing.get_context("spawn").Process(target=_rank_entry, args=(r, world, workdir, task, payload))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
        check(not alive and codes == [0] * world, f"{task}: ranks {alive} still running, exit codes {codes}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_reports(stdout):
    """The training CLI's ``[dist]`` lines, by rank."""
    decoder = json.JSONDecoder()
    reports = [decoder.raw_decode(part)[0] for part in stdout.split("[dist] ")[1:] if part.startswith("{")]
    return {r["rank"]: r for r in reports}


def _opened_state(cfg):
    """The config's model from seed 0 on the CPU with the SDF's encoding
    columns opened and the tables drawn U(-0.1, 0.1), so the tables get
    gradient (the parity phases' state)."""
    import torch
    from mlinerf_tpu_torch.config import resolve

    model = resolve("model", cfg.model.type)(cfg.model, cfg.data, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        w = model.neural_sdf.mlp.linear_0.weight
        w[:, 3:] = torch.randn(w[:, 3:].shape, generator=torch.Generator().manual_seed(1)) * 0.3
        for t in model.neural_sdf.hash_table:
            t.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _ddp_trainer(case, device, logdir):
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(case["config"], cli_args=case["args"])
    for key, value in case["runtime"].items():
        cfg.runtime[key] = value
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=logdir, device=device)
    trainer.model.load_state_dict(case["state"])
    return trainer


def _ddp_parity_rank(rank, payload):
    """A rank of ddp_parity: each case's two steps on its global batch; the
    ranks' logged means, the parameters, the optimizer state (sharded leaves
    gathered) and this rank's scatter launches."""
    import torch
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    out = {}
    for case in payload["cases"]:
        trainer = _ddp_trainer(case, "cuda:0", os.path.join(payload["logdir"], case["name"], str(rank)))
        batch = {k: v.to("cuda:0") for k, v in case["batch"].items()}
        before, logged = hashgrid_scatter.launches, []
        for _ in range(2):
            info = trainer.train_step(batch)
            means, _ = trainer.dp.reduce_info(torch.stack([info["total"], *info["losses"].values()]), info["grad_sq"])
            logged.append(dict(zip(["total", *info["losses"]], means.tolist())))
        torch.cuda.synchronize()
        opt = trainer.optimizer.state_dict()
        if trainer.dp.shards:
            opt = trainer._sharded_state(opt, trainer.dp.gather_leaf)
        out[case["name"]] = dict(logged=logged, launches=hashgrid_scatter.launches - before, opt=opt,
                                 params={k: v.cpu() for k, v in trainer.model.state_dict().items()},
                                 sharded=len(trainer.dp.shards), global_layout=trainer.dp.global_layout)
        del trainer
        torch.cuda.empty_cache()
    return out


def _loss_grads(trainer, batch):
    """The train step's total and gradients on ``batch`` (no combine, no
    update)."""
    import torch

    it = trainer.current_iteration
    cond = trainer.make_cond(it)
    cond["max_levels"] = trainer.static_max_levels_for(it)
    weights = trainer.loss_weights_at(it, cond)
    output = trainer.model(batch, cond, generator=trainer.render_generator, train=True)
    losses, _ = trainer.compute_loss(output, batch, mode="train")
    total = sum(weights[k] * v for k, v in losses.items() if k in weights)
    grads = torch.autograd.grad(total, trainer.trainable_params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainer.trainable_params, grads)]
    return total.detach().item(), grads


def _one_process_steps(case, half_mean):
    """The case's two steps in this process on the card: the whole batch,
    or (half_mean) the mean of the two half batches' gradients, the
    reference of DDP (JAX's shard_map + pmean)."""
    import torch

    trainer = _ddp_trainer(case, "cuda", os.path.join(SMOKE_LOGDIR + "_ddp_ref", case["name"]))
    batch = {k: v.to("cuda") for k, v in case["batch"].items()}
    totals = []
    for _ in range(2):
        if half_mean:
            n = batch["ray_idx"].shape[1] // 2
            halves = [{k: v[:, r * n:(r + 1) * n] if k == "ray_idx" or k.endswith("_sampled") else v
                       for k, v in batch.items()} for r in range(2)]
            parts = [_loss_grads(trainer, half) for half in halves]
            trainer.optimizer.step([(a + b) / 2 for a, b in zip(parts[0][1], parts[1][1])])
            trainer.current_iteration += 1
            totals.append((parts[0][0] + parts[1][0]) / 2)
        else:
            totals.append(float(trainer.train_step(batch)["total"]))
    params = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    lr = float(trainer.lr_fn(1))
    del trainer
    torch.cuda.empty_cache()
    return dict(totals=totals, params=params, lr=lr)


def _params_err(got, want, lr, what):
    """Largest |got - want| over the leaves, held against 1e-6 + 4 x lr:
    the scatter's float32 atomics sum in another order on every run, and
    Adam turns a gradient that rounds to another sign into up to 2 x lr."""
    tol = 1e-6 + 4 * lr
    err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    check(err <= tol, f"{what}: a parameter differs by {err} > {tol}")
    return err, tol


def phase_ddp_parity():
    """Two gloo ranks on the card (the TINY model, spawned here), each
    layout two steps on one injected global batch, against one process on
    the card: grad_psum True against the mean of the two half batches'
    gradients; False against the whole batch, stage a and stage b (its
    coupled losses on the gathered batch); shard_tables against
    replicated. The ranks' parameters bitwise equal; the scatter launches
    per rank. Returns the launches of both ranks."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config

    stage_a = os.path.join(HERE, "configs", "syn_sphere_a.yaml")
    stage_b = os.path.join(HERE, "configs", "syn_sphere_b.yaml")
    cfg_a = Config(stage_a, cli_args=TINY)
    batch = _tiny_batch(cfg_a)
    rng = np.random.default_rng(0)
    rays = batch["ray_idx"].shape[1]
    batch_b = dict(batch, pseudo_ref_sampled=torch.from_numpy(rng.uniform(0, 1.2, (1, rays, 3)).astype(np.float32)),
                   pseudo_sha_sampled=torch.from_numpy(rng.uniform(0, 1, (1, rays, 1)).astype(np.float32)),
                   pseudo_visibility_certainty_sampled=torch.from_numpy(
                       rng.uniform(0, 1, (1, rays, 1)).astype(np.float32)))

    def case(name, runtime, config=stage_a, extra=(), b=batch):
        args = _override(TINY, extra)
        return dict(name=name, config=config, args=args, runtime=runtime, batch=b,
                    state=_opened_state(Config(config, cli_args=args)))

    cases = [case("ddp", {"grad_psum": True}), case("global", {"grad_psum": False}),
             case("global_b", {"grad_psum": False}, config=stage_b, extra=STAGE_B_TINY, b=batch_b),
             case("replicated13", {"grad_psum": False}, extra=DDP_TABLES),
             case("sharded13", {"shard_tables": True}, extra=DDP_TABLES)]
    t0 = time.perf_counter()
    ranks = _spawn_ranks(2, "_ddp_parity_rank", dict(cases=cases, logdir=SMOKE_LOGDIR + "_ddp_parity"))
    ranks_s = time.perf_counter() - t0
    refs = {"ddp": _one_process_steps(cases[0], half_mean=True), "global": _one_process_steps(cases[1], False),
            "global_b": _one_process_steps(cases[2], False)}
    report, launches = {}, 0
    for name in ("ddp", "global", "global_b", "replicated13", "sharded13"):
        r0, r1 = ranks[0][name], ranks[1][name]
        check(r0["logged"] == r1["logged"] and all(torch.equal(p, r1["params"][k]) for k, p in r0["params"].items()),
              f"ddp_parity {name}: the two ranks' parameters or logs differ")
        want_launches = 0 if name == "global_b" else 2 * 2 * cfg_a.model.object.sdf.encoding.levels
        check(r0["launches"] == r1["launches"] == want_launches,
              f"ddp_parity {name}: scatter launches per rank {r0['launches']}, {r1['launches']}; "
              f"expected {want_launches}")
        launches += r0["launches"] + r1["launches"]
        entry = dict(launches_per_rank=[r0["launches"], r1["launches"]], global_layout=r0["global_layout"],
                     sharded_leaves=r0["sharded"])
        if name in refs:
            ref = refs[name]
            loss_err = max(abs(a["total"] - b) / abs(b) for a, b in zip(r0["logged"], ref["totals"]))
            check(loss_err <= 1e-5, f"ddp_parity {name}: logged total off by {loss_err} (relative) > 1e-5")
            entry.update(loss_rel_err=loss_err, loss_tol=1e-5)
            entry["param_max_abs_err"], entry["param_tol"] = _params_err(r0["params"], ref["params"], ref["lr"],
                                                                         f"ddp_parity {name}")
        report[name] = entry
    rep, zero = ranks[0]["replicated13"], ranks[0]["sharded13"]
    check(zero["sharded"] > 0 and rep["sharded"] == 0, f"ddp_parity: {zero['sharded']} sharded tables")
    report["sharded13"]["param_max_abs_err"], report["sharded13"]["param_tol"] = _params_err(
        zero["params"], rep["params"], refs["global"]["lr"], "ddp_parity sharded13 against replicated13")
    moment_err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
                     for key in ("mu", "nu") for a, b in zip(zero["opt"][key], rep["opt"][key]))
    check(moment_err <= 1e-3, f"ddp_parity: sharded moments off by {moment_err} of their leaf max")
    report["sharded13"].update(moment_err_rel_to_leaf_max=moment_err, moment_tol=1e-3)
    emit("ddp_parity", world=2, backend="gloo", device="cuda:0 (both ranks)", model="syn_sphere_a/b TINY",
         steps=2, ranks_wall_s=ranks_s, cases=report)
    return launches


def phase_ddp_train():
    """``python -m torch.distributed.run --nproc_per_node=<cards> -m
    mlinerf_tpu_torch.train`` on configs/syn_prodscale_a.yaml at full width
    with ``--runtime.grad_psum=True`` (NCCL), 1 warm-up + 5 steps: step ms,
    the combine's ms (CUDA events) and bytes per step, peak memory and
    scatter launches per rank; rank 0 alone writes; the checkpoint loads in
    one process. Returns the launches of every rank."""
    import torch
    from mlinerf_tpu_torch.config import Config, resolve

    count = torch.cuda.device_count()
    shutil.rmtree(DDP_LOGDIR, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", f"--nproc_per_node={count}",
           "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "-m", "mlinerf_tpu_torch.train",
           "--config", PRODSCALE, "--logdir", DDP_LOGDIR, f"--max_iter={TRAIN_STEPS}", "--logging_iter=1",
           f"--checkpoint.save_iter={TRAIN_STEPS}", "--model.object.sdf.encoding.coarse2fine.enabled!",
           "--runtime.grad_psum=True"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"ddp_train: the launcher exited {run.returncode}: {run.stderr[-3000:]}")
    reports = _dist_reports(run.stdout)
    check(sorted(reports) == list(range(count)), f"ddp_train: [dist] lines of ranks {sorted(reports)}")
    check([r["rank"] for r in reports.values() if r["writes"]] == [0], "ddp_train: a rank but rank 0 writes")
    records = [json.loads(line) for line in open(os.path.join(DDP_LOGDIR, "metrics.jsonl"))]
    check([r["step"] for r in records] == list(range(1, TRAIN_STEPS + 1)), "ddp_train: metrics.jsonl is not one "
                                                                             "line per step")
    check(all(math.isfinite(r["train/total_loss"]) for r in records), "ddp_train: non-finite loss")
    levels = Config(PRODSCALE).model.object.sdf.encoding.levels
    check(all(r["scatter_launches"] == 2 * levels * TRAIN_STEPS for r in reports.values()),
          f"ddp_train: scatter launches per rank {[r['scatter_launches'] for r in reports.values()]}")
    checkpoints = sorted(n for n in os.listdir(DDP_LOGDIR) if n.endswith("_checkpoint.pkl"))
    cfg = Config(PRODSCALE, cli_args=["--model.object.sdf.encoding.coarse2fine.enabled!"])
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=DDP_LOGDIR + "_load", device="cuda")
    check(trainer.load_checkpoint(os.path.join(DDP_LOGDIR, "latest_checkpoint.txt"), resume=True)
          and trainer.current_iteration == TRAIN_STEPS and trainer.optimizer.count == TRAIN_STEPS,
          "ddp_train: the checkpoint does not load in one process at its iteration")
    del trainer
    torch.cuda.empty_cache()
    step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
    rays = cfg.model.render.rand_rays * cfg.data.train.batch_size
    emit("ddp_train", config="configs/syn_prodscale_a.yaml", world=count, backend="nccl", grad_psum=True,
         cut="6 steps; coarse-to-fine off", rays_per_step=rays, rays_per_rank=rays // count, step_ms=step_ms,
         median_step_ms=statistics.median(step_ms), rays_per_s=rays / (statistics.median(step_ms) / 1e3),
         combine_ms={r: reports[r]["combine_ms"] for r in reports},
         median_combine_ms={r: statistics.median(reports[r]["combine_ms"][1:]) for r in reports},
         combine_bytes_per_step={r: reports[r]["combine_bytes_per_step"] for r in reports},
         peak_mem_bytes={r: reports[r]["peak_mem_bytes"] for r in reports},
         scatter_launches={r: reports[r]["scatter_launches"] for r in reports}, checkpoints=checkpoints,
         metrics_lines=len(records), loss=[r["train/total_loss"] for r in records], wall_s=wall)
    return sum(r["scatter_launches"] for r in reports.values())


def _ddp2_train_rank(rank, payload):
    """A rank of ddp2_train: the training CLI in this process on the group
    the smoke made; its launches, combine, memory and optimizer bytes."""
    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    torch.cuda.reset_peak_memory_stats()
    trainer = train_cli.main(payload["argv"])
    trainer.dp.combine_ms()
    opt = trainer.optimizer.state_dict()
    return dict(launches=hashgrid_scatter.launches, combine_ms=trainer.dp.step_ms,
                combine_bytes_per_step=trainer.dp.step_bytes, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                writes=trainer.checkpointer.enabled, sharded_leaves=len(trainer.dp.shards),
                moment_bytes=sum(t.numel() * t.element_size() for k in ("mu", "nu") for t in opt[k]),
                params={k: v.cpu() for k, v in trainer.model.state_dict().items()})


def phase_ddp2_train():
    """configs/syn_prodscale_a.yaml at full width on two gloo ranks on the
    one card (512 of the 1024 rays each), through the training CLI in each
    rank: the grad_psum arm and the shard_tables arm, 1 + 3 steps each.
    Then one rank's launches (a step of its 512 rays) replayed. Returns the
    launches of both ranks and arms."""
    import torch
    from mlinerf_tpu_torch.config import Config, resolve

    levels = Config(PRODSCALE).model.object.sdf.encoding.levels
    arms, launches = {}, 0
    for arm in ("grad_psum", "shard_tables"):
        logdir = os.path.join(DDP2_LOGDIR, arm)
        shutil.rmtree(logdir, ignore_errors=True)
        argv = ["--config", PRODSCALE, "--logdir", logdir, "--device", "cuda:0", f"--max_iter={DDP2_STEPS}",
                "--logging_iter=1", f"--checkpoint.save_iter={DDP2_STEPS}",
                "--model.object.sdf.encoding.coarse2fine.enabled!", f"--runtime.{arm}=True"]
        t0 = time.perf_counter()
        ranks = _spawn_ranks(2, "_ddp2_train_rank", dict(argv=argv))
        wall = time.perf_counter() - t0
        records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
        check([r["step"] for r in records] == list(range(1, DDP2_STEPS + 1))
              and all(math.isfinite(r["train/total_loss"]) for r in records), f"ddp2_train {arm}: metrics.jsonl")
        writers = [r["writes"] for r in ranks]
        check(writers == [True, False], f"ddp2_train {arm}: writers {writers}")
        check(all(r["launches"] == 2 * levels * DDP2_STEPS for r in ranks),
              f"ddp2_train {arm}: scatter launches per rank {[r['launches'] for r in ranks]}")
        check(all(torch.equal(v, ranks[1]["params"][k]) for k, v in ranks[0]["params"].items()),
              f"ddp2_train {arm}: the two ranks' parameters differ")
        check((ranks[0]["sharded_leaves"] > 0) == (arm == "shard_tables"), f"ddp2_train {arm}: sharded leaves")
        launches += sum(r["launches"] for r in ranks)
        step_ms = [1e3 * r["train/iter_time"] for r in records[1:]]
        arms[arm] = dict(step_ms=step_ms, median_step_ms=statistics.median(step_ms),
                         combine_ms=[r["combine_ms"] for r in ranks],
                         median_combine_ms=[statistics.median(r["combine_ms"][1:]) for r in ranks],
                         combine_bytes_per_step=[r["combine_bytes_per_step"] for r in ranks],
                         peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
                         moment_bytes=[r["moment_bytes"] for r in ranks], sharded_leaves=ranks[0]["sharded_leaves"],
                         scatter_launches=[r["launches"] for r in ranks], loss=[r["train/total_loss"] for r in records],
                         wall_s=wall)
    rays_per_rank = Config(PRODSCALE).model.render.rand_rays // 2
    emit("ddp2_train", config="configs/syn_prodscale_a.yaml", world=2, backend="gloo", device="cuda:0 (both ranks)",
         cut=f"{DDP2_STEPS} steps; coarse-to-fine off", rays_per_rank=rays_per_rank, arms=arms)
    # One rank's launches: a step of the rank's slice (512 rays), recorded
    # after two steps and replayed through the kernel, the plain version and
    # index_add_.
    cfg = Config(PRODSCALE, cli_args=["--model.object.sdf.encoding.coarse2fine.enabled!", "--max_iter=2",
                                      f"--model.render.rand_rays={rays_per_rank}"])
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, logdir=os.path.join(DDP2_LOGDIR, "rank_step"),
                                                   device="cuda")
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    trainer.train(arrays)
    captured = capture_step(trainer, {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()})
    check(len(captured) == 2 * levels, f"ddp2_train: {len(captured)} launches in one rank's step")
    del trainer, arrays
    torch.cuda.empty_cache()
    phase_replay(captured, phase="ddp2_replay", case="captured_step_rank_of_2")
    return launches


def phase_runtime():
    """The trainer's runtime options on the card: grad_accum_iter 2, SGD and
    RAdam (TINY, two steps from the same weights and batch, card against
    CPU), trainer.init.type xavier, a validation writing its three PNGs,
    and ``train.py --profile`` for two steps of syn_prodscale_a, whose
    table must show the scatter kernel's row. Returns the scatter launches
    of the profiled run."""
    import contextlib
    import io

    import torch
    from mlinerf_tpu_torch import train as train_cli
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    stage_a = os.path.join(HERE, "configs", "syn_sphere_a.yaml")
    report = {}
    for name, extra in (("grad_accum_iter", ["--trainer.grad_accum_iter=2"]), ("sgd", ["--optim.type=SGD"]),
                        ("radam", ["--optim.type=RAdam"])):
        cfg = Config(stage_a, cli_args=TINY + ["--optim.sched.warm_up_end=0"] + extra)
        state, batch = _opened_state(cfg), _tiny_batch(cfg)
        results = {}
        for device in ("cpu", "cuda"):
            trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, device=device,
                                                           logdir=os.path.join(SMOKE_LOGDIR + "_runtime", device))
            trainer.model.load_state_dict(state)
            totals = [float(trainer.train_step({k: v.to(device) for k, v in batch.items()})["total"])
                      for _ in range(2)]
            params = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
            results[device] = dict(totals=totals, params=params, lr=float(trainer.lr_fn(0)),
                                   moved=any(not torch.equal(v, state[k]) for k, v in params.items()))
        cpu, gpu = results["cpu"], results["cuda"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu["totals"], cpu["totals"]))
        check(loss_err <= 1e-4, f"runtime {name}: card and CPU totals differ by {loss_err} (relative)")
        check(gpu["moved"] and cpu["moved"], f"runtime {name}: two steps left the parameters as they were")
        err, tol = _params_err(gpu["params"], cpu["params"], cpu["lr"], f"runtime {name}")
        report[name] = dict(overrides=extra, loss_rel_err=loss_err, loss_tol=1e-4, param_max_abs_err=err,
                            param_tol=tol)
    # trainer.init: drawn on the CPU from seed + 9999, then moved.
    cfg = Config(stage_a, cli_args=TINY + ["--trainer.init.type=xavier"])
    init = {d: resolve("trainer", cfg.trainer.type)(cfg, seed=0, device=d, logdir=SMOKE_LOGDIR + "_runtime")
            .model.state_dict() for d in ("cpu", "cuda")}
    plain = _opened_state(Config(stage_a, cli_args=TINY))
    dense = [k for k in init["cpu"] if k.endswith(".weight") and init["cpu"][k].ndim == 2 and "hash_table" not in k]
    check(all(torch.equal(init["cuda"][k].cpu(), init["cpu"][k]) for k in init["cpu"]),
          "runtime: trainer.init differs between the card and the CPU")
    check(all(not torch.equal(init["cpu"][k], plain[k]) for k in dense), "runtime: trainer.init left a dense weight")
    w = init["cuda"]["neural_rgb.mlp.linear_1.weight"]
    report["init_xavier"] = dict(dense_weights=len(dense), std=float(w.std()), want_std=(1 / 64) ** 0.5)
    check(abs(report["init_xavier"]["std"] / report["init_xavier"]["want_std"] - 1) < 0.1,
          f"runtime: xavier std {report['init_xavier']['std']}")
    # Validation images.
    logdir = SMOKE_LOGDIR + "_runtime_val"
    shutil.rmtree(logdir, ignore_errors=True)
    cfg = Config(stage_a, cli_args=TINY)
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=0, device="cuda", logdir=logdir)
    psnr = trainer.validate(resolve("dataset", cfg.data.type)(cfg, is_inference=True), step=1, max_samples=1)
    images = sorted(os.listdir(os.path.join(logdir, "images", "000000001")))
    check(images == ["val_normal.png", "val_rgb_render.png", "val_rgb_target.png"] and math.isfinite(psnr),
          f"runtime: validation wrote {images}")
    report["validation"] = dict(images=images, psnr=psnr)
    # --profile, two steps of syn_prodscale_a.
    logdir = SMOKE_LOGDIR + "_profile"
    shutil.rmtree(logdir, ignore_errors=True)
    out = io.StringIO()
    hashgrid_scatter.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--config", PRODSCALE, "--logdir", logdir, "--max_iter=2", "--logging_iter=1", "--profile",
                        "--model.object.sdf.encoding.coarse2fine.enabled!"])
    wall = time.perf_counter() - t0
    table = out.getvalue().split("== device time by category", 1)
    scatter_rows = [line for line in table[-1].splitlines() if line.strip().startswith("scatter:")]
    check(len(table) == 2 and len(scatter_rows) == 1 and "scatter_add_rows_kernel" in scatter_rows[0],
          f"runtime: the --profile table's scatter row is {scatter_rows}")
    rows = [line for line in table[1].splitlines() if "%" in line]
    launches = hashgrid_scatter.launches
    check(launches == 2 * 2 * Config(PRODSCALE).model.object.sdf.encoding.levels,
          f"runtime: {launches} scatter launches in the two profiled steps")
    report["profile"] = dict(trace_bytes=os.path.getsize(os.path.join(logdir, "profile", "trace.json")),
                             table=rows[:14], scatter_launches=launches, wall_s=wall)
    emit("runtime", **report)
    return launches


# The last modules of the JAX package: bf16 on the SDF models, the rest of
# the camera math, the indirect-light probe and the bench.
AMP_LOGDIR = os.path.join(HERE, "logs", "chip_smoke_amp")
AMP_ARGS = ["--trainer.amp_config.enabled"]
# The probe on the train phase's checkpoint: the JAX package's defaults
# (probe resolution 300, so 90,000 rays per hemisphere, grid fraction 0.3)
# on a view cut from 256x256 to PROBE_SIZE, which leaves one probed pixel
# (45, 45) of the full width's 3 x 3.
PROBE_SIZE = 64


def phase_amp_parity():
    """The TINY Lumen model, and the TINY neuralangelo model with the
    background and embeddings, with bf16 MLPs: one training forward and
    backward on the card against the same weights on the CPU within
    AMP_TOL; 2 scatter launches per level on the card."""
    from mlinerf_tpu_torch.config import Config

    report = {}
    for name, extra in (("lumen", []), ("neuralangelo", ANGELO_TINY)):
        cfg = Config(os.path.join(HERE, "configs", "syn_sphere_a.yaml"), cli_args=TINY + extra + AMP_ARGS)
        report[name] = _card_vs_cpu_step(cfg, f"amp_parity {name}", compute_dtype="bfloat16", tol=AMP_TOL)
        levels = cfg.model.object.sdf.encoding.levels
        check(report[name]["scatter_launches_cuda"] == 2 * levels,
              f"amp_parity {name}: {report[name]['scatter_launches_cuda']} scatter launches on the card")
    emit("amp_parity", compute_dtype="bfloat16", tol=AMP_TOL, cases=report)


def phase_amp_train(train_stats):
    """configs/syn_prodscale_a.yaml with ``--trainer.amp_config.enabled``
    through the training CLI: 1 + 5 steps with bf16 MLPs (float32
    parameters, bf16 tables), 32 scatter launches per step; step ms and
    peak memory beside the train phase's (float32 MLPs); then one more step
    with its launches recorded."""
    import torch
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.models.mlp import WNDense

    trainer, fields = _train_paper_config("amp_train", PRODSCALE, AMP_LOGDIR, AMP_ARGS, images_dtype="torch.float32")
    dtypes = {m.compute_dtype for m in trainer.model.modules() if isinstance(m, WNDense)}
    check(dtypes == {torch.bfloat16}, f"amp_train: dense layers compute in {dtypes}")
    params = {str(p.dtype) for n, p in trainer.model.named_parameters() if ".hash_table." not in n}
    check(params == {"torch.float32"}, f"amp_train: parameters in {params}")
    emit("amp_train", cut="6 steps; coarse-to-fine off (all 16 levels live)", overrides=AMP_ARGS,
         compute_dtype="bfloat16", fp32_median_step_ms=train_stats["median_step_ms"],
         step_ms_vs_fp32=fields["median_step_ms"] / train_stats["median_step_ms"],
         fp32_peak_mem_bytes=train_stats["peak_mem_bytes"],
         peak_mem_vs_fp32=fields["peak_mem_bytes"] / train_stats["peak_mem_bytes"], **fields)
    arrays = {k: torch.as_tensor(v, device="cuda")
              for k, v in resolve("dataset", trainer.cfg.data.type)(trainer.cfg).as_arrays().items()}
    captured = capture_step(trainer, arrays)
    check(len(captured) == 2 * trainer.cfg.model.object.sdf.encoding.levels,
          f"amp_train: {len(captured)} launches recorded in one step")
    check({str(vals.dtype) for _, vals, _ in captured} == {"torch.bfloat16"},
          "amp_train: the table cotangent reaches the scatter in another dtype than the tables' bf16")
    del trainer, arrays
    torch.cuda.empty_cache()
    return fields["scatter_launches"], captured


def phase_camera():
    """The camera functions beyond the rays and NDC on the card
    against the CPU on the same inputs (within 1e-6 of max(1, the largest
    magnitude), the Taylor series and the samplers' rotation 2e-6; the
    frustum test and the square unwrap bitwise at N = 4096), then the
    unwrap at the probe's default N = 90,000 on the card (its distances
    float64, in column chunks)."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.utils import camera, hemisphere

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 3, generator=gen) * 0.5
    wu = torch.randn(64, 6, generator=gen) * 0.3
    q1, q2 = torch.randn(64, 4, generator=gen), torch.randn(64, 4, generator=gen)
    pose = camera.se3_to_SE3(wu)
    intr = torch.tensor([[[40.0, 0, 18], [0, 40.0, 32], [0, 0, 1]]])
    pts = torch.randn(64, 3, generator=gen) * 2
    anchor = torch.nn.functional.normalize(torch.randn(8, 3, generator=gen), dim=-1)
    uniforms = [(torch.rand(8, 512, generator=gen), torch.rand(8, 512, generator=gen)) for _ in range(9)]
    cases = {
        "pose_compose": lambda d: camera.pose_compose([pose.to(d), camera.pose_scale_center(pose.to(d), 2.0),
                                                       camera.pose_from_Rt(t=wu[:, :3].to(d))]),
        "q_product_q_invert": lambda d: camera.q_product(q1.to(d), camera.q_invert(q2.to(d))),
        "so3_to_SO3": lambda d: camera.so3_to_SO3(w.to(d)),
        "SO3_to_so3": lambda d: camera.SO3_to_so3(camera.so3_to_SO3(w.to(d))),
        "se3_to_SE3": lambda d: camera.se3_to_SE3(wu.to(d)),
        "SE3_to_se3": lambda d: camera.SE3_to_se3(pose.to(d)),
        "world2cam_cam2img": lambda d: camera.cam2img(camera.world2cam(pts.to(d), pose[:1].to(d)), intr.to(d)),
        "angle_to_rotation_matrix": lambda d: camera.angle_to_rotation_matrix(w[:, 0].to(d), "Y"),
        "rotation_distance": lambda d: camera.rotation_distance(pose[:, :, :3].to(d), pose.flip(0)[:, :, :3].to(d)),
        "sample_on_spherical_cap": lambda d: camera.sample_on_spherical_cap(
            anchor.to(d), 512, 0.4, uniforms=[u.to(d) for u in uniforms[0]]),
        "sample_on_spherical_cap_northern": lambda d: camera.sample_on_spherical_cap_northern(
            anchor.to(d), 512, 1.2, away_from=-anchor.roll(1, 0).to(d), uniforms=[[u.to(d) for u in p] for p in uniforms]),
    }
    errs = {}
    for name, fn in cases.items():
        got, want = fn("cuda").cpu(), fn("cpu")
        check(bool(torch.isfinite(got).all()), f"camera: non-finite {name} on the card")
        errs[name] = float((got - want).abs().max() / max(1.0, float(want.abs().max())))
        bound = 2e-6 if "3" in name or "sample" in name else 1e-6
        check(errs[name] <= bound, f"camera: {name} differs by {errs[name]} between the card and the CPU")
    # The frustum test, on a view 36 wide and 64 high (x held against H).
    inside = lambda d: camera.inside_camera_view(intr.to(d), pose[:1].to(d), (64, 36), pts.to(d))
    check(torch.equal(inside("cuda").cpu(), inside("cpu")), "camera: inside_camera_view differs on the card")
    index, mask, _ = hemisphere.square_interpolation(4096, device="cuda")
    want_index, want_mask, _ = hemisphere.square_interpolation(4096)
    check(np.array_equal(index, want_index) and np.array_equal(mask, want_mask),
          "camera: square_interpolation(4096) differs between the card and the CPU")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index, mask, (S, _) = hemisphere.square_interpolation(300**2, device="cuda")
    unwrap_s = time.perf_counter() - t0
    check(index.shape == (S * S,) and 0 <= index.min() and index.max() < 300**2 and mask.any(),
          "camera: square_interpolation(90000) on the card gave a bad index")
    emit("camera", err_rel_to_max1=errs, tol=dict(default=1e-6, series_and_samplers=2e-6),
         square_interpolation_90000=dict(device="cuda", seconds=unwrap_s, side=S, pixels_in_disc=int(mask.sum()),
                                         chunk_elements=hemisphere.CHUNK_ELEMENTS["cuda"]))


def phase_indirect_probe():
    """``pipelines.indirect_light.indirect_light_probe`` on the train
    phase's checkpoint (syn_prodscale_a at full width) with the JAX
    package's defaults, the view cut to PROBE_SIZE: one probed pixel, its
    90,000 secondary rays; finite mosaic of the expected shape, 0 scatter
    launches, seconds and peak memory."""
    import numpy as np
    import torch
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.pipelines.indirect_light import indirect_light_probe

    size = f"[{PROBE_SIZE},{PROBE_SIZE}]"
    cfg = Config(PRODSCALE, cli_args=["--model.object.sdf.encoding.coarse2fine.enabled!",
                                      f"--data.train.image_size={size}", f"--data.val.image_size={size}"])
    trainer = resolve("trainer", cfg.trainer.type)(cfg, is_inference=True, seed=0, logdir=SMOKE_LOGDIR, device="cuda")
    check(trainer.load_checkpoint(os.path.join(SMOKE_LOGDIR, "latest_checkpoint.txt")),
          "indirect_probe: no checkpoint in the train phase's logdir")
    sample = resolve("dataset", cfg.data.type)(cfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if k in ("pose", "intr", "pose_light")}
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _no_scatter("indirect_probe", lambda: indirect_light_probe(trainer, data, (PROBE_SIZE, PROBE_SIZE)))
    seconds = time.perf_counter() - t0
    mosaic = out["indirect_rgb"]
    grid = (len(out["grid_rows"]), len(out["grid_cols"]))
    check(grid == (1, 1) and mosaic.shape == (300, 300, 3), f"indirect_probe: grid {grid}, mosaic {mosaic.shape}")
    check(bool(np.isfinite(mosaic).all()), "indirect_probe: non-finite mosaic")
    emit("indirect_probe", checkpoint=os.path.relpath(os.path.join(SMOKE_LOGDIR, "latest_checkpoint.txt"), HERE),
         cut=f"view {PROBE_SIZE}x{PROBE_SIZE} (full width 256x256): grid 1x1 of the full width's 3x3",
         probe_resolution=300, grid_fraction=0.3, grid=[out["grid_rows"], out["grid_cols"]],
         secondary_rays=300**2 * grid[0] * grid[1], chunk_rays=trainer.num_val_rays(), seconds=seconds,
         secondary_rays_per_s=300**2 / seconds, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         held_before_bytes=held_before,
         mosaic_shape=list(mosaic.shape), mosaic_mean=float(mosaic.mean()), scatter_launches=0)
    del trainer
    torch.cuda.empty_cache()


def phase_bench():
    """``python -m mlinerf_tpu_torch.bench`` in process at its default
    config (the JAX package's shipped fast path at 512x512, 2048 rays),
    without the render: bench.py's JSON line and its scatter launches (one
    warm and BENCH_ITERS timed steps at iterations 0-5, where coarse-to-fine
    leaves init_active_level levels live, each one lookup of the stencil:
    one launch per live level per step). Returns the launches."""
    import contextlib
    import io

    from mlinerf_tpu_torch import bench
    from mlinerf_tpu_torch.ops import hashgrid_scatter

    saved = {k: os.environ.get(k) for k in ("BENCH_SKIP_RENDER", "BENCH_ITERS")}
    os.environ["BENCH_SKIP_RENDER"], os.environ["BENCH_ITERS"] = "1", "5"
    hashgrid_scatter.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            line = bench.main([])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launches = hashgrid_scatter.launches
    check(out.getvalue().strip().splitlines()[-1] == json.dumps(line), "bench: the JSON line is not the last printed")
    check(list(line)[:4] == ["metric", "value", "unit", "vs_baseline"] and line["value"] > 0
          and math.isfinite(line["value"]), f"bench: bad line {line}")
    enc = bench.build_bench_cfg().model.object.sdf.encoding
    live = min(enc.coarse2fine.init_active_level, enc.levels)
    check(launches == live * 6, f"bench: {launches} scatter launches in 6 steps, expected {live} per step")
    emit("bench", line=line, scatter_launches=launches, live_levels=live, wall_s=wall)
    return launches


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler breakdowns of two more train steps (prodscale, ReNe, syn_e2e_a, "
                             "nerf_blender, ingp_blender, neuralangelo, analytical), one more image render "
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
    launches, captured, train_stats = phase_train(profile=args.profile)
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fixtures_")
    try:
        fx = phase_fixtures(tmp)
        rene_launches, captured = phase_rene_train(fx, profile=args.profile)
        rene = phase_replay(captured, phase="rene_replay", case="captured_step_dict22")
        del captured
        phase_rene_render(fx)
        labels = phase_rene_labels()
        phase_rene_train_b(fx, labels)
        phase_rene_test(fx)
        phase_video(fx)
        hotdog_launches = phase_hotdog(fx)
        phase_dataset_parity(fx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_e2e_parity()
    e2e_launches, captured = phase_e2e_train(profile=args.profile)
    e2e = phase_replay(captured, phase="e2e_replay", case="captured_step_e2e")
    del captured
    phase_e2e_render()
    phase_e2e_train_b()
    variant_launches = phase_variants()
    phase_nerf_parity()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nerf_")
    try:
        fx = phase_nerf_fixtures(tmp)
        phase_nerf_train(fx, profile=args.profile)
        ingp_launches, captured = phase_ingp_train(fx, profile=args.profile)
        ingp = phase_replay(captured, phase="ingp_replay", case="captured_step_ingp")
        del captured
        phase_llff_train(fx)
        phase_nerf_render(fx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_angelo_parity()
    angelo_launches = phase_angelo_train(profile=args.profile)
    analytical_launches, captured = phase_analytical_train(profile=args.profile)
    analytical = phase_replay(captured, phase="analytical_replay", case="captured_step_analytical")
    del captured
    phase_angelo_render()
    ddp_launches = phase_ddp_parity() + phase_ddp_train() + phase_ddp2_train()
    runtime_launches = phase_runtime()
    phase_amp_parity()
    amp_launches, captured = phase_amp_train(train_stats)
    amp = phase_replay(captured, phase="amp_replay", case="captured_step_amp")
    del captured
    phase_camera()
    phase_indirect_probe()
    bench_launches = phase_bench()
    summary["max_abs_err"] = max(summary["max_abs_err"], max_err, rene["max_abs_err"], e2e["max_abs_err"],
                                 ingp["max_abs_err"], analytical["max_abs_err"], amp["max_abs_err"])
    summary["launches"] = (launches + rene_launches + hotdog_launches + e2e_launches + variant_launches + ingp_launches
                           + angelo_launches + analytical_launches + ddp_launches + runtime_launches + amp_launches
                           + bench_launches)
    print(json.dumps({"kernels": [summary]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
