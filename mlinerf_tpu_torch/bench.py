"""Throughput benchmark of the stage-a training step and the full-image
render, the port's counterpart of the JAX package's ``bench.py``:
``python -m mlinerf_tpu_torch.bench [--device cuda|cpu]``.

The configuration is ``bench.py``'s, built the same way from
``configs/base_sdf.yaml`` on the procedural scene at 512x512 with 2048 rays
per step, and selected by the same environment: ``BENCH_CONFIG`` names one
of its configurations (``reference`` is the reference's published shape:
dict 2^22, L16 F8, 64 + 4x16 samples, exact 4-tap gradients; the default,
``composedautoslev4blk``, is the JAX package's shipped fast path: dict 2^19,
32 + 2x16 samples, the auto stencil, sampling levels 4, blocked dense
levels), and the ``BENCH_*`` knobs override single keys. ``BENCH_SMALL``
shrinks the table, the images and the rays for a CPU run. ``BENCH_ITERS``
(5) steps are timed after one warm step, each ending in a host read of its
loss; ``BENCH_SKIP_RENDER`` skips the render, which is timed over
``BENCH_RENDER_REPEATS`` (2) renders in ``INF_CHUNK`` (4096) ray chunks
after a warm one.

Prints one JSON line with ``bench.py``'s keys: ``value`` is the training
rays/s (rays per step over the median step time), ``vs_baseline`` its
ratio to BASELINE_RAYS_PER_SEC. The TPU-only parts have no counterpart:
one step per dispatch (no scan window) and no roofline of TPU row rates,
so ``attainable_rays_per_sec`` and ``vs_attainable`` are null.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's CUDA throughput envelope, not a TPU figure: Neuralangelo-
# class training runs 500k iterations in about 16 h on an A100-class GPU,
# about 8.7 it/s x 2048 rays = 17.8k rays/s, rounded to 18,000 (bench.py).
BASELINE_RAYS_PER_SEC = 18_000.0
DEFAULT_CONFIG = "composedautoslev4blk"
# Every name BENCH_CONFIG takes.
CONFIGS = ("reference", "budget", "lvl12", "composed", "composedhf8", "composedauto", "composed12", "composed12f8",
           "composed12topk", "composedcs", "composedcs17", "composedcstop1", "composedcstop1f4", "tuned",
           "composedblk", "composedhf8blk", "composedhf8slev4blk", "composedautoblk", "composedautoslev4blk")


def build_bench_cfg():
    """The benchmark's config from ``BENCH_CONFIG`` and the ``BENCH_*``
    knobs (the same config as ``bench.py``'s ``build_bench_cfg``)."""
    from mlinerf_tpu_torch.config import Config

    cfg = Config(os.path.join(HERE, "configs", "base_sdf.yaml"))
    cfg.trainer.type = "lumen"
    cfg.model.type = "lumen"
    cfg.model.background.enabled = False
    cfg.model.background.white = True
    cfg.model.light_visibility = {
        "enabled": False,
        "camera_ray_type": "blend_z_sphere_tracing",
        "type": "sphere_tracing",
        "visibility_bounding_type": "sphere",
        "visibility_sphere_radius": 0.95,
    }
    cfg.model.render.rand_rays = 2048
    cfg.model.render.rand_rays_val = 8192
    cfg.max_iter = 500000
    cfg.data.type = "synthetic"
    cfg.data.num_cameras = 8
    cfg.data.num_lights = 4
    cfg.data.white_background = True
    cfg.data.train.image_size = [512, 512]
    cfg.data.train.batch_size = 1
    cfg.data.val.image_size = [512, 512]
    cfg.data.train.load_iid = False
    cfg.data.val.load_iid = False
    cfg.data.bounding_type = "unit_sphere"
    cfg.logging_iter = 10**12
    cfg.validation_iter = 10**12
    cfg.checkpoint.save_iter = 10**12
    cfg.checkpoint.save_latest_iter = 10**12
    cfg.timeout_period = 9999999
    env = os.environ
    grad = cfg.model.object.sdf.gradient
    e = cfg.model.object.sdf.encoding
    # The shared-level stencil: an int or "auto" (default 0, the exact taps).
    shared = env.get("BENCH_SHARED_LEVELS", "0")
    if shared not in ("0", ""):
        grad.shared_levels = shared if shared == "auto" else int(shared)
    named = env.get("BENCH_CONFIG", DEFAULT_CONFIG)
    # Suffixes compose: "blk" = blocked dense levels, "slev4" = sampling_levels 4.
    if named in ("composedblk", "composedhf8blk", "composedhf8slev4blk", "composedautoblk", "composedautoslev4blk"):
        if "slev4" in named:
            cfg.model.render.sampling_levels = 4
        e.hashgrid.dense_blocked = True
        named = ("composedauto" if named.startswith("composedauto")
                 else "composedhf8" if named.startswith("composedhf8") else "composed")
    if named in ("budget", "lvl12", "composed", "composedhf8", "composedauto", "composed12", "composed12f8",
                 "composed12topk", "composedcs", "composedcs17", "composedcstop1", "composedcstop1f4"):
        # dict 2^19 (2^17 for composedcs17) and 32 + 2x16 samples.
        e.hashgrid.dict_size = 17 if named == "composedcs17" else 19
        cfg.model.render.num_samples.coarse = 32
        cfg.model.render.num_sample_hierarchy = 2
        if named in ("lvl12", "composed12", "composed12f8", "composed12topk"):
            e.levels = 12
        if named.startswith("composed"):
            if shared == "auto" or named == "composedauto":
                # Every level but the finest shared, no separate hessian pass.
                grad.shared_levels = "auto"
                grad.hessian.mode = "shared"
            else:
                # Every level shared, the exact hessian on a strided subset.
                grad.shared_levels = e.levels
                grad.hessian.mode = "exact"
                grad.hessian.fraction = 0.125 if named in ("composedhf8", "composed12f8", "composed12topk") else 0.25
        if named.startswith("composedcs"):
            grad.corner_sample.enabled = True
        if named.startswith("composedcstop1"):
            # The exact argmax row plus one sampled row, table LR x2.83.
            grad.corner_sample.mode = "top1cot"
            cfg.optim.lr_scales = {"hash_table": 2.83}
        if named == "composedcstop1f4":
            e.hashgrid.dim = 4
            e.hashgrid.dict_size = 18
        if named == "composed12topk":
            grad.subsample.enabled = True
            grad.subsample.topk = 16
            grad.subsample.stride = 8
    elif named == "tuned":
        e.hashgrid.dict_size = 18
        e.levels = 8
        e.hashgrid.dim = 16
        cfg.model.render.num_samples.coarse = 32
        cfg.model.render.num_sample_hierarchy = 2
    elif named != "reference":
        raise SystemExit(f"unknown BENCH_CONFIG={named}")
    # Single keys.
    if env.get("BENCH_DICT_SIZE"):
        e.hashgrid.dict_size = int(env["BENCH_DICT_SIZE"])
    for var, key in (("BENCH_COARSE", "coarse"), ("BENCH_FINE", "fine")):
        if env.get(var):
            cfg.model.render.num_samples[key] = int(env[var])
    if env.get("BENCH_HIER"):
        cfg.model.render.num_sample_hierarchy = int(env["BENCH_HIER"])
    if env.get("BENCH_LEVELS"):
        e.levels = int(env["BENCH_LEVELS"])
        e.coarse2fine.init_active_level = min(e.coarse2fine.init_active_level, int(env["BENCH_LEVELS"]))
    if env.get("BENCH_DIM"):
        e.hashgrid.dim = int(env["BENCH_DIM"])
    if env.get("BENCH_SDF_WIDTH"):
        cfg.model.object.sdf.mlp.hidden_dim = int(env["BENCH_SDF_WIDTH"])
    if env.get("BENCH_HESS_MODE"):
        grad.hessian.mode = env["BENCH_HESS_MODE"]
    if env.get("BENCH_HESS_FRACTION"):
        grad.hessian.fraction = float(env["BENCH_HESS_FRACTION"])
    if env.get("BENCH_DENSE_BLOCKED"):
        e.hashgrid.dense_blocked = True
    if env.get("BENCH_SAMPLING_LEVELS"):
        cfg.model.render.sampling_levels = int(env["BENCH_SAMPLING_LEVELS"])
    if env.get("BENCH_MESH"):
        cfg.runtime.mesh = env["BENCH_MESH"]
    # Partial training: "tables" freezes the hash tables, "sdf" the SDF.
    freeze = env.get("BENCH_FREEZE")
    if freeze == "tables":
        cfg.optim.partial_training = ["mlp", "s_var"]
    elif freeze == "sdf":
        cfg.optim.partial_training = ["neural_rgb"]
    elif freeze:
        raise SystemExit(f"unknown BENCH_FREEZE={freeze}")
    if env.get("BENCH_CORNER_SAMPLE"):
        grad.corner_sample.enabled = True
        if env.get("BENCH_CORNER_FLOOR"):
            grad.corner_sample.floor = float(env["BENCH_CORNER_FLOOR"])
    if env.get("BENCH_CORNER_MODE"):
        grad.corner_sample.mode = env["BENCH_CORNER_MODE"]
    if env.get("BENCH_CORNER_EXACT_FINEST"):
        grad.corner_sample.exact_finest = int(env["BENCH_CORNER_EXACT_FINEST"])
    if env.get("BENCH_TABLE_LR_SCALE"):
        cfg.optim.lr_scales = {"hash_table": float(env["BENCH_TABLE_LR_SCALE"])}
    if env.get("BENCH_TOPK"):
        grad.subsample.enabled = True
        grad.subsample.topk = int(env["BENCH_TOPK"])
        if env.get("BENCH_TOPK_STRIDE") is not None:
            grad.subsample.stride = int(env["BENCH_TOPK_STRIDE"])
    return cfg


def semantics_delta(cfg):
    """Each key where the config differs from the reference's published
    shape, as "reference -> this"."""
    e = cfg.model.object.sdf.encoding
    grad = cfg.model.object.sdf.gradient
    ref = {"dict_size": 22, "levels": 16, "features_per_level": 8, "coarse": 64, "hierarchy": 4,
           "shared_levels": 0, "hessian": "n/a (exact taps)", "corner_sample": False, "table_lr_scale": 1.0,
           "dense_blocked": False, "sampling_levels": "all"}
    cur = {"dict_size": int(e.hashgrid.dict_size), "levels": int(e.levels), "features_per_level": int(e.hashgrid.dim),
           "coarse": int(cfg.model.render.num_samples.coarse),
           "hierarchy": int(cfg.model.render.num_sample_hierarchy), "shared_levels": grad.shared_levels,
           "hessian": f"{grad.hessian.mode} f={grad.hessian.fraction}" if grad.shared_levels else "n/a (exact taps)",
           "corner_sample": bool(grad.corner_sample.enabled) and str(grad.corner_sample.mode),
           "table_lr_scale": float((cfg.optim.get("lr_scales", {}) or {}).get("hash_table", 1.0)),
           "dense_blocked": bool(e.hashgrid.get("dense_blocked", False)),
           "sampling_levels": cfg.model.render.get("sampling_levels") or "all"}
    return {k: f"{ref[k]} -> {cur[k]}" for k in ref if cur[k] != ref[k]}


def _synced(trainer):
    if trainer.device.type == "cuda":
        import torch

        torch.cuda.synchronize(trainer.device)


def measure_render(cfg, trainer) -> float:
    """Rays/s of a full-image render of the first validation view, median
    over BENCH_RENDER_REPEATS renders after a warm one."""
    import numpy as np

    from mlinerf_tpu_torch.config import resolve

    H, W = cfg.data.val.image_size
    sample = resolve("dataset", cfg.data.type)(cfg, is_inference=True).get_full_sample(0)
    data = {k: np.asarray(v)[None] for k, v in sample.items() if k in ("pose", "intr", "pose_light")}
    chunk = int(os.environ.get("INF_CHUNK", 4096))
    out = trainer.render_image(data, (H, W), num_rays_chunk=chunk)
    if not np.isfinite(out["rgb"]).all():
        raise RuntimeError("bench: the render is not finite")
    times = []
    for _ in range(int(os.environ.get("BENCH_RENDER_REPEATS", 2))):
        t0 = time.perf_counter()
        trainer.render_image(data, (H, W), num_rays_chunk=chunk)  # ends in the copy to the host
        times.append(time.perf_counter() - t0)
    return round(H * W / statistics.median(times), 1)


def measure(device=None):
    """Build the config, train BENCH_ITERS timed steps after a warm one,
    render, and return the JSON line's fields."""
    import torch

    from mlinerf_tpu_torch.config import resolve

    cfg = build_bench_cfg()
    if os.environ.get("BENCH_SMALL"):
        cfg.model.object.sdf.encoding.hashgrid.dict_size = 15
        cfg.data.train.image_size = [64, 64]
        cfg.data.val.image_size = [64, 64]
        cfg.model.render.rand_rays = 256
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    with tempfile.TemporaryDirectory(prefix="mlinerf_bench_") as logdir:
        trainer = resolve("trainer", cfg.trainer.type)(cfg, logdir=logdir, device=device)
        arrays = {k: torch.as_tensor(v, device=trainer.device) for k, v in arrays.items()}
        float(trainer.train_step(trainer.sample_batch(arrays))["total"])  # warm
        times = []
        for _ in range(int(os.environ.get("BENCH_ITERS", 5))):
            _synced(trainer)
            t0 = time.perf_counter()
            float(trainer.train_step(trainer.sample_batch(arrays))["total"])
            times.append(time.perf_counter() - t0)
        rays_per_sec = cfg.model.render.rand_rays * cfg.data.train.batch_size / statistics.median(times)
        render_rays_per_sec = None if os.environ.get("BENCH_SKIP_RENDER") else measure_render(cfg, trainer)
    return {
        "metric": "train_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        "vs_target_2x_a100": round(rays_per_sec / (2 * BASELINE_RAYS_PER_SEC), 3),
        "render_rays_per_sec": render_rays_per_sec,
        "attainable_rays_per_sec": None,
        "vs_attainable": None,
        "config": os.environ.get("BENCH_CONFIG", DEFAULT_CONFIG),
        "semantics_delta_vs_reference": semantics_delta(cfg) or "none (reference-exact)",
        "steps_per_dispatch": 1,
        "window_times_s": [round(t, 3) for t in sorted(times)],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Training and render throughput (PyTorch port)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args = parser.parse_args(argv)
    line = measure(args.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
