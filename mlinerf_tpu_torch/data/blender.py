"""The NeRF-synthetic (Blender) dataset, ``nerf_blender``, and the
Blender-convention pose helpers the other Blender-layout datasets share.

``transforms_{train,val}.json`` list each frame's ``file_path`` (a PNG
without its extension) and OpenGL camera-to-world ``transform_matrix``;
``camera_angle_x`` gives the focal length at the output size. RGBA frames
are resized to Pillow's definition (premultiplied alpha), composited on
``data.bgcolor`` in float32 and stored as uint8 with +0.5 rounding
(``Dataset.as_arrays``), as the JAX package's loader does.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.data.base import Dataset as BaseDataset, pick_subset
from mlinerf_tpu_torch.utils.image_io import load_image

_GL_TO_CV = np.asarray([1, -1, -1, 1], np.float32)


def gl_to_cv(c2w: np.ndarray) -> np.ndarray:
    """Flip the y and z camera axes (columns 1 and 2) of a camera-to-world pose."""
    return c2w * _GL_TO_CV[None, :]


def invert_pose(c2w34: np.ndarray) -> np.ndarray:
    """[3,4] camera-to-world -> [3,4] world-to-camera, float32."""
    R, t = c2w34[:3, :3], c2w34[:3, 3]
    R_inv = R.T
    return np.concatenate([R_inv, (-R_inv @ t)[:, None]], axis=-1).astype(np.float32)


@register("dataset", "nerf_blender")
class Dataset(BaseDataset):
    images_uint8 = True

    def __init__(self, cfg, is_inference: bool = False, is_test: bool = False):
        super().__init__(cfg, is_inference=is_inference, is_test=is_test)
        cfg_data = cfg.data
        self.root = cfg_data.root
        split = "val" if is_inference else "train"
        self.H, self.W = cfg_data[split].image_size
        with open(os.path.join(self.root, f"transforms_{split}.json")) as f:
            self.meta = json.load(f)
        self.list = pick_subset(self.meta["frames"], cfg_data[split].get("subset"))
        self.bgcolor = cfg_data.get("bgcolor", 1.0)
        self._camera_angle_x = float(self.meta["camera_angle_x"])
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def get_image(self, idx: int) -> np.ndarray:
        return load_image(os.path.join(self.root, self.list[idx]["file_path"] + ".png"), size=(self.W, self.H))

    def get_camera(self, idx: int):
        focal = 0.5 * self.W / np.tan(0.5 * self._camera_angle_x)
        intr = np.asarray([[focal, 0, self.W / 2], [0, focal, self.H / 2], [0, 0, 1]], np.float32)
        c2w = gl_to_cv(np.asarray(self.list[idx]["transform_matrix"], np.float32))
        return intr, invert_pose(c2w[:3])

    def get_full_sample(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        image = self.get_image(idx)
        if image.shape[-1] == 4:
            rgb, a = image[..., :3], image[..., 3:]
            image = rgb * a + self.bgcolor * (1 - a)
        intr, pose = self.get_camera(idx)
        sample = dict(idx=idx, image=image.astype(np.float32), intr=intr, pose=pose)
        self._cache[idx] = sample
        return sample
