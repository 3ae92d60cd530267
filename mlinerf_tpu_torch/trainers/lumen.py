"""MLI-NeRF (Lumen) trainer, stage a: the Neuralangelo losses on the
light-conditioned model. The stage-b intrinsic, weighted-shading and
residual losses are not ported yet."""

from __future__ import annotations

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.trainers.neuralangelo import Trainer as AngeloTrainer


@register("trainer", "lumen")
class Trainer(AngeloTrainer):
    def __init__(self, cfg, seed: int = 0, logdir=None, device=None):
        for key in ("intrinsic", "regularize_re", "weighted_shading"):
            if cfg.trainer.get("loss_weight", {}).get(key) is not None:
                raise NotImplementedError(f"trainer.loss_weight.{key} (stage b) is not ported")
        super().__init__(cfg, seed=seed, logdir=logdir, device=device)

    def _needs_light(self) -> bool:
        return True

    # pixel_array_keys: stage a gathers the images only (the base class's);
    # stage b adds the pseudo-label maps.
