"""The LLFF (real forward-facing) dataset, ``nerf_llff``: ``poses_bounds.npy``
and ``images/``.

Each row of ``poses_bounds.npy`` [N,17] holds a [3,5] matrix, the
[down, right, back] camera-to-world columns and (H, W, focal) at the
capture size, then the near and far bounds. As the JAX package's loader
does: the columns are swapped to [right, up, back], the translations and
bounds rescaled so the nearest bound sits at 4/3 (bd factor 0.75), the
poses recentred on their average, turned to OpenCV's axes, and every
``val_ratio``-th view held out for validation. The intrinsics are rescaled
to the output size, ``fy`` by the height's factor.

Frames are JPEG (the real captures) or PNG, read and resized as the JAX
package's Pillow reads them (utils/image_io.py).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.data.base import Dataset as BaseDataset, pick_subset
from mlinerf_tpu_torch.utils.image_io import load_image


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _average_pose(c2ws):
    center = c2ws[:, :3, 3].mean(0)
    z = _normalize(c2ws[:, :3, 2].sum(0))
    y_ = c2ws[:, :3, 1].sum(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], axis=1)  # [3,4]


@register("dataset", "nerf_llff")
class Dataset(BaseDataset):
    images_uint8 = True

    def __init__(self, cfg, is_inference: bool = False, is_test: bool = False):
        super().__init__(cfg, is_inference=is_inference, is_test=is_test)
        cfg_data = cfg.data
        self.root = cfg_data.root
        split = "val" if is_inference else "train"
        self.H, self.W = cfg_data[split].image_size
        poses_bounds = np.load(os.path.join(self.root, "poses_bounds.npy"))  # [N,17]
        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, 15:]
        # [down right back] -> [right up back].
        c2w = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], axis=-1)
        self.raw_H, self.raw_W, self.focal_raw = poses[0, :, 4]
        scale = 1.0 / (self.bounds.min() * 0.75)
        c2w[..., 3] *= scale
        self.bounds = self.bounds * scale
        avg44 = np.vstack([_average_pose(c2w), [0, 0, 0, 1]])
        c2w44 = np.concatenate([c2w, np.broadcast_to(np.asarray([0, 0, 0, 1.0]), (len(c2w), 1, 4))], axis=1)
        c2w = (np.linalg.inv(avg44)[None] @ c2w44)[:, :3]
        # [right up back] -> OpenCV's [right down forward].
        c2w = c2w * np.asarray([1, -1, -1, 1])[None, None, :]
        self.c2ws = c2w.astype(np.float32)
        img_dir = os.path.join(self.root, "images")
        files = sorted(f for f in os.listdir(img_dir) if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if len(files) != len(self.c2ws):
            raise ValueError(f"{self.root}: {len(self.c2ws)} poses in poses_bounds.npy, {len(files)} images")
        ratio = cfg_data.get("val_ratio", 8)
        val_ids = set(range(0, len(files), ratio))
        ids = [i for i in range(len(files)) if (i in val_ids) == is_inference]
        self.list = pick_subset([dict(file=files[i], pose_id=i) for i in ids], cfg_data[split].get("subset"))
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def get_full_sample(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        frame = self.list[idx]
        image = load_image(os.path.join(self.root, "images", frame["file"]), size=(self.W, self.H))[..., :3]
        focal = self.focal_raw * self.W / self.raw_W
        # The JAX loader's fy line, then its overwrite by the height's factor.
        intr = np.asarray([[focal, 0, self.W / 2],
                           [0, focal * self.H / self.W * self.raw_W / self.raw_H * 1.0, self.H / 2],
                           [0, 0, 1]], np.float32)
        intr[1, 1] = self.focal_raw * self.H / self.raw_H
        c2w = self.c2ws[frame["pose_id"]]
        R, t = c2w[:3, :3], c2w[:3, 3]
        pose = np.concatenate([R.T, (-R.T @ t)[:, None]], axis=-1).astype(np.float32)
        sample = dict(idx=idx, image=image.astype(np.float32), intr=intr, pose=pose)
        self._cache[idx] = sample
        return sample
