"""Multi-light dataset with per-frame light poses (ReNe-style annotations).

A ``transforms.json`` per split (``data.<split>.annotation``, else
``<root>/<split>_transforms.json``) with ``transform_matrix`` and
``transform_matrix_light`` per frame: sphere re-centring and scaling
(``sphere_center``, ``sphere_radius``, ``data.readjust``), the
``use_light_index`` filter and ``subset``, skewed intrinsics scaled from the
raw frame size to ``image_size``, pseudo labels for stage b, camera/light
tag lookup and the closest-frame search. Images are read as the JAX
package's Pillow reads them (PNG or JPEG, by signature; utils/image_io.py),
resized to Pillow's definition where their size is not ``image_size``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.data.base import Dataset as BaseDataset, pick_subset
from mlinerf_tpu_torch.data.blender import gl_to_cv, invert_pose
from mlinerf_tpu_torch.pipelines.label_store import load_results_all
from mlinerf_tpu_torch.utils.image_io import read_image, resize


@register("dataset", "lumen")
class Dataset(BaseDataset):
    images_uint8 = True

    def __init__(self, cfg, is_inference: bool = False, is_test: bool = False):
        super().__init__(cfg, is_inference=is_inference, is_test=is_test)
        cfg_data = cfg.data
        self.root = cfg_data.root
        split = "val" if is_inference else "train"
        self.split_name = split
        self.H, self.W = cfg_data[split].image_size
        if "annotation" in cfg_data[split] and cfg_data[split].annotation:
            meta_fname = cfg_data[split].annotation
        else:
            meta_fname = os.path.join(self.root, f"{split}_transforms.json")
        with open(meta_fname) as f:
            self.meta = json.load(f)
        self.meta.setdefault("sphere_center", [0.0, 0.0, 0.0])
        self.meta.setdefault("sphere_radius", 1.0)
        if cfg_data[split].get("use_light_index"):
            use = cfg_data[split].use_light_index
            self.meta["frames"] = [f for f in self.meta["frames"] if f["light_index"] in use]
        self.list = pick_subset(self.meta["frames"], cfg_data[split].get("subset"))
        self.readjust = cfg_data.get("readjust", None)
        # Pseudo labels (stage b).
        self.has_pseudo_label = False
        pl_cfg = cfg_data[split].get("pseudo_label") if split == "train" else None
        if pl_cfg and pl_cfg.get("enabled"):
            self.pseudo_label = load_results_all(pl_cfg.pt_file)
            self.has_pseudo_label = True
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._raw_size: Optional[tuple] = None
        self._center_ray_info = None

    # ------------------------------------------------------------------

    def _normalize_c2w(self, c2w: np.ndarray) -> np.ndarray:
        center = np.asarray(self.meta["sphere_center"], np.float32)
        if self.readjust:
            center = center + np.asarray(self.readjust.get("center", [0, 0, 0]), np.float32)
        scale = float(self.meta["sphere_radius"])
        if self.readjust:
            scale = scale * float(self.readjust.get("scale", 1.0))
        c2w = c2w.copy()
        c2w[:3, -1] = (c2w[:3, -1] - center) / scale
        return c2w

    def _load(self, fpath: str) -> np.ndarray:
        """The image at ``fpath`` as float32 [H,W,C], Pillow's array divided
        by 255, at ``image_size``, resized where its raw size differs;
        records the raw (W, H)."""
        img, mode = read_image(fpath)
        if self._raw_size is None:
            self._raw_size = (img.shape[1], img.shape[0])  # (W,H)
        if img.shape[:2] != (self.H, self.W):
            img = resize(img, (self.W, self.H), mode)
        return img.astype(np.float32) / np.float32(255.0)

    def get_image(self, idx: int) -> np.ndarray:
        fpath = os.path.normpath(os.path.join(self.root, self.list[idx]["file_path"]))
        return self._load(fpath)[..., :3]

    def _scale_intrinsics(self, intr: np.ndarray, idx: int) -> np.ndarray:
        """Intrinsics of the raw frame, scaled to ``image_size``."""
        if self._raw_size is None:
            self.get_image(idx)
        raw_W, raw_H = self._raw_size
        intr = intr.copy()
        intr[0] *= self.W / raw_W
        intr[1] *= self.H / raw_H
        return intr

    def get_camera(self, idx: int):
        m = self.meta
        intr = np.asarray(
            [[m["fl_x"], m.get("sk_x", 0.0), m["cx"]],
             [m.get("sk_y", 0.0), m["fl_y"], m["cy"]],
             [0, 0, 1]], np.float32,
        )
        intr = self._scale_intrinsics(intr, idx)
        c2w_gl = np.asarray(self.list[idx]["transform_matrix"], np.float32)
        c2w = self._normalize_c2w(gl_to_cv(c2w_gl))
        return intr, invert_pose(c2w[:3])

    def get_light(self, idx: int) -> np.ndarray:
        c2w_gl = np.asarray(self.list[idx]["transform_matrix_light"], np.float32)
        c2w = self._normalize_c2w(gl_to_cv(c2w_gl))
        return invert_pose(c2w[:3])

    # ------------------------------------------------------------------

    def find_closest_idx(self, pose_cam: np.ndarray, pose_light) -> int:
        """The frame closest to a camera pose (centre distance plus one minus
        the cosine of the viewing directions) and, if given, a light pose
        (centre distance)."""
        def cam_center_dir(pose):
            R, t = pose[:3, :3], pose[:3, 3]
            c = -R.T @ t
            d = R.T @ np.asarray([0.0, 0.0, 1.0])
            return c, d

        if self._center_ray_info is None:
            cams = [self.get_camera(i)[1] for i in range(len(self))]
            lights = [self.get_light(i) for i in range(len(self))]
            self._center_ray_info = (
                np.stack([cam_center_dir(p)[0] for p in cams]),
                np.stack([cam_center_dir(p)[1] for p in cams]),
                np.stack([cam_center_dir(p)[0] for p in lights]),
            )
        centers, dirs, light_centers = self._center_ray_info
        c, d = cam_center_dir(np.asarray(pose_cam))
        dist_c = np.linalg.norm(centers - c, axis=-1)
        cos = np.sum(dirs * d, axis=-1) / (
            np.linalg.norm(dirs, axis=-1) * np.linalg.norm(d) + 1e-12
        )
        dist_d = 1.0 - cos
        total = dist_c + dist_d
        if pose_light is not None:
            lc, _ = cam_center_dir(np.asarray(pose_light))
            total = total + np.linalg.norm(light_centers - lc, axis=-1)
        return int(np.argmin(total))

    # ------------------------------------------------------------------

    def get_full_sample(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        image = self.get_image(idx)
        intr, pose = self.get_camera(idx)
        sample = dict(idx=idx, image=image, intr=intr, pose=pose, pose_light=self.get_light(idx))
        self._cache[idx] = sample
        return sample

    def _pseudo_label_keys(self, idx: int):
        """(camera_key, light_key) into the pseudo-label store for frame idx."""
        frame = self.list[idx]
        return str(frame.get("camera_index", idx)), str(frame.get("light_index", 0))

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """The base class's arrays, plus, with pseudo labels loaded, each
        frame's labels from its (camera, light) keys: pseudo_ref [N,H,W,3],
        pseudo_sha and pseudo_visibility_certainty [N,H,W,1]."""
        out = super().as_arrays()
        if self.has_pseudo_label:
            refs, shas, vis = [], [], []
            for i in range(len(self)):
                cam, light = self._pseudo_label_keys(i)
                node = self.pseudo_label[cam]
                refs.append(np.asarray(node["pseudo_reflectance"], np.float32))
                shas.append(np.asarray(node[light]["pseudo_shading_gamma"], np.float32))
                vis.append(np.asarray(node[light]["visibility_certainty"], np.float32))
            out["pseudo_ref"] = self._to_hwc(np.stack(refs), 3)
            out["pseudo_sha"] = self._to_hwc(np.stack(shas), 1)
            out["pseudo_visibility_certainty"] = self._to_hwc(np.stack(vis), 1)
        return out

    @staticmethod
    def _to_hwc(arr: np.ndarray, channels: int) -> np.ndarray:
        """Accept [N,C,H,W] (the reference's .pt layout) or [N,H,W,C]/[N,H,W]."""
        if arr.ndim == 3:
            return arr[..., None]
        if arr.shape[1] == channels and arr.shape[-1] != channels:
            return np.moveaxis(arr, 1, -1)
        return arr
