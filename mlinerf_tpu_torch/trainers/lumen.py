"""MLI-NeRF (Lumen) trainer: stage a (the Neuralangelo losses on the
light-conditioned model), stage b (the intrinsic, weighted-shading and
residual losses on the radiance heads, against the pseudo labels that ride
along per picked ray) and ``test_all_light``, the per-(camera, light)
renders with light visibility that the pseudo-label pipeline reads."""

from __future__ import annotations

import functools
import os
import random
from typing import Dict

import numpy as np

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.pipelines.label_store import save_results_all
from mlinerf_tpu_torch.trainers.base import outputs_to_maps
from mlinerf_tpu_torch.trainers.neuralangelo import Trainer as AngeloTrainer
from mlinerf_tpu_torch.utils import losses as loss_lib
from mlinerf_tpu_torch.utils.image_io import save_image


def get_random_other_index(num_indexes: int, length_selected: int, seed: int = 0):
    """For each frame, [itself + (length-1) random other frames]: the
    'unpair' pseudo-label setting. Python's ``random``, seeded, as the JAX
    package draws them, so both pick the same (camera, light) pairs."""
    random.seed(seed)
    index_lists = []
    for i in range(num_indexes):
        current = [i]
        others = [j for j in range(num_indexes) if j != i]
        current.extend(random.sample(others, length_selected - 1))
        index_lists.append(current)
    return index_lists


@register("trainer", "lumen")
class Trainer(AngeloTrainer):
    def __init__(self, cfg, is_inference: bool = False, seed: int = 0, logdir=None, device=None):
        super().__init__(cfg, is_inference=is_inference, seed=seed, logdir=logdir, device=device)
        tcfg = cfg.trainer
        if "intrinsic" in self.weights:
            p = tcfg.para_intrinsic_loss
            self.criteria_intrinsic = functools.partial(
                loss_lib.intrinsic_loss,
                weight_map_range_shading=tuple(p["weight_map_range_shading"]),
                weight_map_range_visibility=tuple(p["weight_map_range_visibility"]),
                factor_ref=p["factor_ref"], factor_sha=p["factor_sha"])
        if "regularize_re" in self.weights:
            p = tcfg.para_regularize_re_loss
            self.criteria_regularize_re = functools.partial(
                loss_lib.regularize_re_loss, factor_negative=p["factor_negative"],
                factor_positive=p["factor_positive"], exponent_positive=p["exponent_positive"])
        if "weighted_shading" in self.weights:
            self.criteria_weighted_shading = functools.partial(
                loss_lib.weighted_shading_loss,
                weight_range=tuple(tcfg.get("weighted_shading_weight_range", (0.0, 1.0))))

    def _needs_light(self) -> bool:
        return True

    def pixel_array_keys(self):
        """The images, and the pseudo-label maps where the dataset has them."""
        return [("images", "image_sampled"), ("pseudo_ref", "pseudo_ref_sampled"),
                ("pseudo_sha", "pseudo_sha_sampled"),
                ("pseudo_visibility_certainty", "pseudo_visibility_certainty_sampled")]

    def compute_loss(self, output, batch, mode: str):
        losses, metrics = super().compute_loss(output, batch, mode)
        if mode == "train":
            if "weighted_shading" in self.weights and "o_s" in output:
                losses["weighted_shading"] = self.criteria_weighted_shading(output["o_s"], output["pseudo_shading"])
            if "intrinsic" in self.weights and "pseudo_ref_sampled" in batch:
                losses["intrinsic"] = self.criteria_intrinsic(
                    output["o_r"], output["o_s"], batch["pseudo_ref_sampled"], batch["pseudo_sha_sampled"],
                    batch["pseudo_visibility_certainty_sampled"])
            if "regularize_re" in self.weights and "o_re" in output:
                losses["regularize_re"] = self.criteria_regularize_re(output["o_re"])
        elif "regularize_re" in self.weights and "o_re_map" in output:
            losses["regularize_re"] = self.criteria_regularize_re(output["o_re_map"])
        return losses, metrics

    # ------------------------------------------------------------------
    # Pseudo-label renders over (camera, light) combinations
    # ------------------------------------------------------------------

    def test_all_light(self, dataset, output_dir: str, dataset_type: str = "pair",
                       sample_num: int = 4, seed: int = 999):
        """Render the rgb, normal, visibility and normal.light maps of every
        (camera, light) combination that ``dataset_type`` selects and save
        them as ``<output_dir>/results_all.npz`` for the pseudo-label
        pipeline, with PNGs under ``<output_dir>/<camera>/``.

        pair: each camera with the lights it was captured under; unpair:
        each frame with the lights of ``sample_num - 1`` other frames drawn
        from ``seed``; limitedlights: each frame with the lights of the
        first ``sample_num`` frames."""
        image_size = self.cfg.data.val.image_size
        if dataset_type == "pair":
            index_info: Dict[int, Dict[int, int]] = {}
            for frame_index in range(len(dataset)):
                frame = dataset.list[frame_index]
                cam = frame.get("camera_index", frame_index)
                index_info.setdefault(cam, {})[frame.get("light_index", 0)] = frame_index
        elif dataset_type == "unpair":
            info = get_random_other_index(len(dataset), sample_num, seed)
            index_info = {cam: dict(enumerate(info[cam])) for cam in range(len(info))}
        elif dataset_type == "limitedlights":
            frames = dataset.list
            pl_index_dict = {frames[i]["pl_index"]: i for i in range(sample_num)}
            index_info = {}
            for cam in range(len(frames)):
                index_info[cam] = {0: cam}
                pls = [p for p in pl_index_dict if p != frames[cam]["pl_index"]]
                for i, p in enumerate(pls):
                    index_info[cam][i + 1] = pl_index_dict[p]
        else:
            raise NotImplementedError(dataset_type)

        results_cam = {}
        for camera_index, lights in index_info.items():
            save_path = os.path.join(output_dir, str(camera_index))
            os.makedirs(save_path, exist_ok=True)
            results_light = {}
            data_input = None
            for light_index, frame_index in lights.items():
                if dataset_type == "pair":
                    sample = dataset.get_full_sample(frame_index)
                elif light_index == 0:
                    data_input = sample = dataset.get_full_sample(camera_index)
                else:
                    sample = dict(data_input)
                    sample["pose_light"] = dataset.get_light(frame_index)
                data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
                maps = self.inference_outputs_light(data, image_size)
                prefix = os.path.join(save_path, f"{light_index}_")
                if dataset_type == "pair" or light_index == 0:
                    save_image(prefix + "rgb_target.png", sample["image"])
                save_image(prefix + "rgb_render.png", maps["rgb_map"][0])
                save_image(prefix + "normal.png", maps["normal_map"][0], from_range=(-1, 1))
                for key in ("visibility", "inter_mask", "normal_x_light", "pseudo_shading"):
                    save_image(prefix + f"{key}.png", maps[key + "_map"][0])
                # The camera-hit distance, min-max normalized.
                dist = maps["inter_dist_map"][0]
                save_image(prefix + "inter_dist.png", dist, from_range=(float(dist.min()), float(dist.max())))
                results = {
                    "normal": maps["normal_map"],
                    "normal_x_light": maps["normal_x_light_map"],
                    "rgb_render": maps["rgb_map"],
                    "visibility": maps["visibility_map"],
                    "inter_mask": maps["inter_mask_map"],
                }
                if dataset_type == "pair":
                    results["rgb_target"] = np.asarray(sample["image"])[None]  # [1,H,W,3]
                results_light[str(light_index)] = results
            results_cam[str(camera_index)] = results_light
        save_results_all(results_cam, os.path.join(output_dir, "results_all"))
        return results_cam

    def inference_outputs_light(self, data, image_size):
        """Inference with the light-visibility branch on; maps [B,H,W,C]."""
        return outputs_to_maps(self.render_image_light(data, image_size), data, image_size)

    def render_image_light(self, data, image_size):
        """Full-image render with the light-visibility branch on."""
        return self.render_image(data, image_size, render_kwargs={"with_light_visibility": True})
