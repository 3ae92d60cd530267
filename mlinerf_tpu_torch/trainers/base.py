"""Training engine: device-resident data, per-step image and ray picks, the
train step (render, loss, backward, AdamW update, gradient norm) and a plain
Python train loop with JSONL logging and the NaN kill-switch.

The training split lives on the device as stacked tensors; each step picks
its image and rays there with an explicit ``torch.Generator``, so the host
only enqueues work and reads the loss at logging steps. Checkpoints and
validation are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlinerf_tpu_torch.config import resolve
from mlinerf_tpu_torch.trainers import optim as optim_lib
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.misc import get_device, require_ported


class MetricsLogger:
    """Appends one JSON object per logging step to ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def log_scalars(self, scalars: Dict[str, float], step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), **{k: float(v) for k, v in scalars.items()}}) + "\n")


class BaseTrainer:
    """Generic trainer: subclasses provide ``compute_loss`` and ``make_cond``."""

    def __init__(self, cfg, seed: int = 0, logdir: Optional[str] = None, device=None):
        self.cfg = cfg
        self.seed = seed
        self.device = get_device(device)
        self.logdir = logdir or cfg.get("logdir") or "logs/default"
        tcfg = cfg.trainer
        require_ported(not tcfg.get("amp_config", {}).get("enabled"), "trainer.amp_config.enabled")
        require_ported(not tcfg.ema_config.enabled, "trainer.ema_config.enabled")
        require_ported(int(tcfg.get("grad_accum_iter", 1) or 1) == 1, "trainer.grad_accum_iter")
        require_ported((tcfg.get("init", {}) or {}).get("type", "none") in (None, "none"), "trainer.init.type")
        require_ported(not (cfg.optim.get("partial_training") or tcfg.get("partial_grad")),
                       "optim.partial_training")

        # Model: initialized on the CPU from the seed, then moved, so the same
        # seed gives the same weights on every device.
        model_cls = resolve("model", cfg.model.type)
        self.model = model_cls(cfg.model, cfg.data, generator=torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        names, params = zip(*self.model.named_parameters())
        self.num_params = sum(p.numel() for p in params)
        print(f"[model] {cfg.model.type}: {self.num_params / 1e6:.2f}M parameters")
        self.table_param_idx = [i for i, n in enumerate(names) if ".hash_table." in n]
        self.optimizer, self.lr_fn = optim_lib.make_optimizer(cfg.optim, params)

        # Image/ray picks and stratified jitter draw from this generator.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.current_iteration = 0
        self.logger = MetricsLogger(self.logdir)
        self.weights = {k: float(v) for k, v in tcfg.get("loss_weight", {}).items() if v is not None}

    # ------------------------------------------------------------------
    # Schedule and loss hooks (overridden per project)
    # ------------------------------------------------------------------

    def make_cond(self, iteration: int) -> Dict[str, Any]:
        return {"progress": np.float32(iteration) / np.float32(self.cfg.max_iter)}

    def static_max_levels_for(self, iteration: int) -> Optional[int]:
        """Hash levels the encoder gathers at ``iteration`` (None = all)."""
        return None

    def loss_weights_at(self, iteration: int, cond) -> Dict[str, float]:
        """Loss weights, float32-rounded Python floats."""
        return {k: float(np.float32(v)) for k, v in self.weights.items()}

    def compute_loss(self, output, batch, mode: str):
        raise NotImplementedError

    def _needs_light(self) -> bool:
        return False

    def pixel_array_keys(self):
        """(array_key, batch_key) pairs gathered per picked ray."""
        return [("images", "image_sampled")]

    def num_rand_rays(self) -> int:
        return self.cfg.model.render.rand_rays

    # ------------------------------------------------------------------
    # Batches
    # ------------------------------------------------------------------

    def sample_batch(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pick ``batch_size`` images and ``rand_rays`` distinct pixels of each."""
        B = self.cfg.data.train.batch_size
        H, W = self.cfg.data.train.image_size
        img_idx = torch.randint(0, arrays["pose"].shape[0], (B,), generator=self.generator,
                                device=self.device)
        ray_idx = samp.random_ray_indices(self.generator, B, H * W, self.num_rand_rays(),
                                          device=self.device)
        return self.gather_batch(arrays, img_idx, ray_idx)

    def gather_batch(self, arrays: Dict[str, torch.Tensor], img_idx: torch.Tensor,
                     ray_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch of images ``img_idx`` [B] and pixels ``ray_idx`` [B,R]."""
        B = img_idx.shape[0]
        H, W = self.cfg.data.train.image_size
        batch = {"idx": img_idx, "ray_idx": ray_idx}
        for key in ("pose", "intr", "pose_light"):
            if key in arrays:
                batch[key] = arrays[key].index_select(0, img_idx)
        for key, out_key in self.pixel_array_keys():
            if key in arrays:
                flat = arrays[key].index_select(0, img_idx).reshape(B, H * W, -1)
                batch[out_key] = samp.slice_by_ray_idx(flat, ray_idx)
        return batch

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One step on ``batch``: render, loss, backward, AdamW update.
        Returns device tensors: total, losses, metrics, grad norms."""
        it = self.current_iteration
        cond = self.make_cond(it)
        cond["max_levels"] = self.static_max_levels_for(it)
        weights = self.loss_weights_at(it, cond)
        output = self.model(batch, cond, generator=self.generator, train=True)
        loss_dict, metric_dict = self.compute_loss(output, batch, mode="train")
        total = torch.zeros((), device=self.device)
        for key, value in loss_dict.items():
            if key in weights:
                total = total + weights[key] * value
        params = self.optimizer.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # A level the encoder skipped has no gradient; optax sees zeros there.
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        info = dict(
            total=total.detach(),
            losses={k: v.detach() for k, v in loss_dict.items()},
            metrics={k: v.detach() for k, v in metric_dict.items()},
            grad_norm=optim_lib.global_norm(grads),
            table_grad_norm=optim_lib.global_norm([grads[i] for i in self.table_param_idx]),
        )
        self.optimizer.step(grads)
        self.current_iteration = it + 1
        return info

    # ------------------------------------------------------------------
    # Train loop
    # ------------------------------------------------------------------

    def train(self, train_arrays: Dict[str, np.ndarray], show_progress: bool = False):
        """Train from the current iteration to ``max_iter``; logs every
        ``logging_iter`` steps and aborts on a non-finite loss there."""
        cfg = self.cfg
        arrays = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in train_arrays.items()}
        if self._needs_light() and "pose_light" not in arrays:
            raise KeyError("this trainer needs per-image light poses ('pose_light')")
        log_iter = min(cfg.logging_iter, cfg.get("wandb_scalar_iter", cfg.logging_iter))
        rays_per_step = self.num_rand_rays() * cfg.data.train.batch_size
        info = None
        t_window, iters_in_window = time.perf_counter(), 0
        while self.current_iteration < cfg.max_iter:
            info = self.train_step(self.sample_batch(arrays))
            it = self.current_iteration
            iters_in_window += 1
            if it % log_iter and it != cfg.max_iter:
                continue
            total = float(info["total"])  # waits for the device
            if not np.isfinite(total):
                raise FloatingPointError(f"Training loss is {total} at iteration {it} — aborting "
                                         "(NaN/Inf kill-switch).")
            dt = (time.perf_counter() - t_window) / iters_in_window
            scalars = {
                "train/total_loss": total,
                "train/iter_time": dt,
                "train/rays_per_sec": rays_per_step / dt,
                "optim/lr": float(self.lr_fn(it)),
                "train/grad_norm": float(info["grad_norm"]),
                "train/table_grad_norm": float(info["table_grad_norm"]),
                **{f"train/loss/{k}": float(v) for k, v in info["losses"].items()},
                **{f"train/{k}": float(v) for k, v in info["metrics"].items()},
            }
            self.logger.log_scalars(scalars, it)
            if show_progress:
                msg = ", ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in scalars.items()
                                if "loss" in k or "psnr" in k)
                print(f"[iter {it}/{cfg.max_iter}] {msg} ({dt * 1000:.1f} ms/it)", flush=True)
            t_window, iters_in_window = time.perf_counter(), 0
        return info
