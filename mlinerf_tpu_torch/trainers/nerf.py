"""NeRF and Instant-NGP trainer: the MSE render loss on the coarse rays and,
with fine sampling, on the fine ones; PSNR of the finest output."""

from __future__ import annotations

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.trainers.base import BaseTrainer
from mlinerf_tpu_torch.utils import losses as loss_lib


@register("trainer", "nerf")
class Trainer(BaseTrainer):
    def __init__(self, cfg, is_inference: bool = False, seed: int = 0, logdir=None, device=None):
        super().__init__(cfg, is_inference=is_inference, seed=seed, logdir=logdir, device=device)
        self.weights.setdefault("render", 1.0)
        if cfg.model.fine_sampling:
            self.weights.setdefault("render_fine", 1.0)

    def num_rand_rays(self) -> int:
        return self.cfg.model.rand_rays

    def compute_loss(self, output, batch, mode: str):
        losses, metrics = {}, {}
        if mode != "train":
            pred = output.get("rgb_map", output["rgb"])
            losses["render"] = loss_lib.mse_loss(pred, batch["image"])
            metrics["psnr"] = loss_lib.psnr(pred, batch["image"])
            return losses, metrics
        target = batch["image_sampled"]
        losses["render"] = loss_lib.mse_loss(output["rgb"], target)
        if "rgb_fine" in output:
            losses["render_fine"] = loss_lib.mse_loss(output["rgb_fine"], target)
        metrics["psnr"] = loss_lib.psnr(*self.global_rays(output.get("rgb_fine", output["rgb"]).detach(), target))
        return losses, metrics
