"""Inference suite: image dumps over a dataset, through the trainer's
full-image renderer. The tag-selected renders and relighting videos of the
JAX package (``test_images``, ``test_video``) are not ported yet."""

from __future__ import annotations

import os

import numpy as np

from mlinerf_tpu_torch.utils.image_io import save_image


def test_save(trainer, dataset, output_dir: str, image_size=None, show_pbar: bool = False):
    """Render every sample and write every ``*_map`` output as
    ``{idx}_{key}.png`` (normal maps from [-1, 1]), and the target as
    ``{idx}_gt.png``."""
    image_size = image_size or trainer.cfg.data.val.image_size
    os.makedirs(output_dir, exist_ok=True)
    for i in range(len(dataset)):
        sample = dataset.get_full_sample(i)
        data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
        maps = trainer.inference_outputs(data, image_size)
        idx = sample.get("idx", i)
        for key, value in maps.items():
            if key.endswith("_map"):
                from_range = (-1, 1) if "normal" in key else (0, 1)
                save_image(os.path.join(output_dir, f"{idx}_{key}.png"), value[0], from_range=from_range)
        if "image" in sample:
            save_image(os.path.join(output_dir, f"{idx}_gt.png"), sample["image"])
        if show_pbar:
            print(f"[test_save] {i + 1}/{len(dataset)}", flush=True)
