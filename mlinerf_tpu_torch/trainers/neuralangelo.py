"""Neuralangelo trainer: L1 render loss (x3), eikonal and curvature
regularizers, the coarse-to-fine schedule and the curvature-weight decay."""

from __future__ import annotations

from typing import Optional

import numpy as np

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.models.fields import make_hashgrid_spec
from mlinerf_tpu_torch.models.neuralangelo import make_cond
from mlinerf_tpu_torch.trainers.base import BaseTrainer
from mlinerf_tpu_torch.utils import losses as loss_lib


@register("trainer", "neuralangelo")
class Trainer(BaseTrainer):
    def __init__(self, cfg, is_inference: bool = False, seed: int = 0, logdir=None, device=None):
        self.warm_up_end = cfg.optim.sched.get("warm_up_end", 0)
        super().__init__(cfg, is_inference=is_inference, seed=seed, logdir=logdir, device=device)

    def make_cond(self, iteration: int):
        return make_cond(self.cfg.model, iteration, self.cfg.max_iter, self.warm_up_end)

    def static_max_levels_for(self, iteration: int) -> Optional[int]:
        """Active-level count at ``iteration`` under coarse-to-fine: the
        encoder skips the levels the mask would zero anyway."""
        cfg_sdf = self.cfg.model.object.sdf
        if not self.cfg.trainer.get("static_level_truncation", True) or cfg_sdf.encoding.type != "hashgrid" \
                or not cfg_sdf.encoding.coarse2fine.enabled:
            return None
        c2f = cfg_sdf.encoding.coarse2fine
        anneal = max((int(iteration) - self.warm_up_end) // c2f.step, 1)
        return int(min(max(c2f.init_active_level, anneal), cfg_sdf.encoding.levels))

    def loss_weights_at(self, iteration: int, cond):
        weights = super().loss_weights_at(iteration, cond)
        cfg_sdf = self.cfg.model.object.sdf
        if "curvature" in weights and cfg_sdf.encoding.type == "hashgrid" and cfg_sdf.encoding.coarse2fine.enabled:
            # Linear warmup, then decay by the level growth factor per
            # annealed level (float32, as the JAX package computes it).
            init_weight = np.float32(weights["curvature"])
            it = np.float32(iteration)
            if it <= self.warm_up_end:
                w = it / np.float32(max(self.warm_up_end, 1)) * init_weight
            else:
                growth = np.float32(make_hashgrid_spec(cfg_sdf.encoding).growth_rate)
                w = init_weight / growth ** (np.float32(cond["anneal_levels"]) - np.float32(1.0))
            weights["curvature"] = float(w)
        return weights

    def compute_loss(self, output, batch, mode: str):
        losses, metrics = {}, {}
        if mode != "train":
            # A full image against its target.
            pred = output.get("rgb_map", output["rgb"])
            losses["render"] = loss_lib.l1_loss(pred, batch["image"])
            metrics["psnr"] = loss_lib.psnr(pred, batch["image"])
            return losses, metrics
        target = batch["image_sampled"]
        # L1 x3, as the reference trainer computes it.
        losses["render"] = loss_lib.l1_loss(output["rgb"], target) * 3
        metrics["psnr"] = loss_lib.psnr(*self.global_rays(output["rgb"].detach(), target))
        if "eikonal" in self.weights:
            losses["eikonal"] = loss_lib.eikonal_loss(output["gradients"], outside=output["outside"])
        if "curvature" in self.weights and output.get("hessians") is not None:
            hess, outside = output["hessians"], output["outside"]
            # The per-ray mask broadcasts over the samples; where it cannot
            # mask this hessian's shape, the model has masked it already.
            try:
                if np.broadcast_shapes(hess.shape[:-1], outside.shape) != tuple(hess.shape[:-1]):
                    outside = None
            except ValueError:
                outside = None
            losses["curvature"] = loss_lib.curvature_loss(hess, outside=outside)
        return losses, metrics
