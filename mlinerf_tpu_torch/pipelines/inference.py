"""Inference suite: image dumps over a dataset, the renders of tagged
frames and the relighting videos, through the trainer's full-image
renderer."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from mlinerf_tpu_torch.utils import camera
from mlinerf_tpu_torch.utils.image_io import annotate, create_collage, save_image, to_uint8, write_apng


def _render_and_save(trainer, sample, output_dir: str, prefix, image_size):
    """Render one sample and write every ``*_map`` output as
    ``{prefix}_{key}.png`` (normal maps from [-1, 1]), and the target as
    ``{prefix}_gt.png``."""
    data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
    maps = trainer.inference_outputs(data, image_size)
    for key, value in maps.items():
        if key.endswith("_map"):
            from_range = (-1, 1) if "normal" in key else (0, 1)
            save_image(os.path.join(output_dir, f"{prefix}_{key}.png"), value[0], from_range=from_range)
    if "image" in sample:
        save_image(os.path.join(output_dir, f"{prefix}_gt.png"), sample["image"])


def test_save(trainer, dataset, output_dir: str, image_size=None, show_pbar: bool = False):
    """Render every sample as ``{idx}_{key}.png`` and ``{idx}_gt.png``."""
    image_size = image_size or trainer.cfg.data.val.image_size
    os.makedirs(output_dir, exist_ok=True)
    for i in range(len(dataset)):
        sample = dataset.get_full_sample(i)
        _render_and_save(trainer, sample, output_dir, sample.get("idx", i), image_size)
        if show_pbar:
            print(f"[test_save] {i + 1}/{len(dataset)}", flush=True)


def test_images(trainer, dataset, output_dir: str, setting_list: Sequence[str] = ("c25l10",), image_size=None):
    """Render the frames of camera/light tags such as 'c25l10' (ReNe) as
    ``{tag}_{key}.png`` and ``{tag}_gt.png``; a tag that ``dataset`` does
    not hold is reported and skipped."""
    image_size = image_size or trainer.cfg.data.val.image_size
    os.makedirs(output_dir, exist_ok=True)
    for setting in setting_list:
        idx = dataset.find_idx_cam_light(setting)
        if idx is None:
            print(f"[test_images] tag {setting} not found", flush=True)
            continue
        _render_and_save(trainer, dataset.get_full_sample(idx), output_dir, setting, image_size)


def test_video(trainer, dataset, idx1: int, idx2: int, output_dir: str, video_content: Sequence[str] = ("rgb", "gt"),
               num_frames: int = 60, image_size=None, show_pbar: bool = False, fps: int = 30) -> str:
    """Novel-view and novel-light video between frames ``idx1`` and
    ``idx2``: the camera pose and the light pose slerped together
    (:func:`camera.pose_interpolate`) by the sine-eased ratio
    sin(f / (num_frames - 1) * pi / 2), each frame a collage of labelled
    tiles in ``video_content`` order (``gt``: the dataset frame closest to
    the interpolated camera and light where the dataset can find it, else
    ``idx1``'s image; any other name: that ``*_map`` of the render), played
    forward then backward. Written as ``video_{idx1}_{idx2}.apng``;
    returns its path."""
    image_size = image_size or trainer.cfg.data.val.image_size
    os.makedirs(output_dir, exist_ok=True)
    sample1 = dataset.get_full_sample(int(idx1))
    sample2 = dataset.get_full_sample(int(idx2))
    has_light = "pose_light" in sample1

    def slerp(key, alpha):
        return camera.pose_interpolate(torch.as_tensor(np.asarray(sample1[key], np.float32)),
                                       torch.as_tensor(np.asarray(sample2[key], np.float32)), alpha).numpy()

    frames = []
    for f in range(num_frames):
        alpha = torch.tensor([float(np.sin(f / (num_frames - 1) * np.pi / 2))], dtype=torch.float32)
        pose = slerp("pose", alpha)
        data = dict(pose=pose[None], intr=np.asarray(sample1["intr"])[None])
        if has_light:
            data["pose_light"] = slerp("pose_light", alpha)[None]
        maps = trainer.inference_outputs(data, image_size)
        tiles = []
        for content in video_content:
            if content == "gt":
                if hasattr(dataset, "find_closest_idx"):
                    gt_idx = dataset.find_closest_idx(pose, data["pose_light"][0] if has_light else None)
                    gt = np.asarray(dataset.get_full_sample(int(gt_idx))["image"])
                else:
                    gt = np.asarray(sample1["image"])
                tiles.append(annotate(to_uint8(gt), "gt (closest)"))
            else:
                key = content if content.endswith("_map") else content + "_map"
                if key in maps:
                    tiles.append(annotate(to_uint8(maps[key][0]), content))
        frames.append(create_collage(tiles))
        if show_pbar:
            print(f"[test_video] frame {f + 1}/{num_frames}", flush=True)
    path = os.path.join(output_dir, f"video_{idx1}_{idx2}.apng")
    write_apng(path, frames + frames[::-1], fps=fps)
    return path
