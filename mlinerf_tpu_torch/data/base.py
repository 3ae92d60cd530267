"""Dataset base: the whole training split exported as stacked arrays.

Training keeps the split on the device as stacked tensors and picks images
and rays there (trainers/base.py ``sample_batch``), so a dataset's job is to
render or load every frame once and stack them (``as_arrays``). Datasets
read from 8-bit files keep their images as uint8 there, a quarter of the
float32 size; the pixel gather decodes them (``gather_batch``).
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def pick_subset(items: List[Any], subset) -> List[Any]:
    """``subset`` items spread evenly over ``items`` (all of them for a falsy
    ``subset``), as the JAX package's loaders pick their ``subset``."""
    if not subset:
        return items
    return [items[i] for i in np.linspace(0, len(items), subset + 1)[:-1].astype(int)]


class Dataset:
    """Base dataset. Subclasses populate ``self.list`` (frame metadata) and
    implement ``get_full_sample``."""

    # File-backed datasets set this: ``as_arrays`` stores their images as
    # uint8.
    images_uint8 = False

    def __init__(self, cfg, is_inference: bool = False, is_test: bool = False):
        self.cfg = cfg
        self.split = "test" if is_test else ("val" if is_inference else "train")
        self.is_inference = is_inference

    def __len__(self):
        return len(self.list)

    def preload_threading(self, load_fn: Callable, num_workers: int) -> List[Any]:
        """``[load_fn(i) for i in range(len(self))]`` on ``num_workers``
        threads (the PNG inflate, the row filters, the JPEG decode and the
        resize release the GIL); the first error raises here."""
        with ThreadPoolExecutor(max(int(num_workers), 1)) as pool:
            return list(pool.map(load_fn, range(len(self))))

    def get_full_sample(self, idx: int) -> Dict[str, np.ndarray]:
        """Eval-style sample: full image + camera (+light), regardless of split."""
        raise NotImplementedError

    def find_idx_cam_light(self, tag: str = "c00l00") -> Optional[int]:
        """The index of the frame of camera and light ``tag`` ('c25l10': the
        first and last numbers), by the frames' ``camera_index`` and
        ``light_index``; None if no frame has them."""
        digits = re.findall(r"\d+", tag)
        cam_idx = int(digits[0]) if digits else None
        light_idx = int(digits[-1]) if digits else None
        for index, frame in enumerate(self.list):
            if frame.get("camera_index") == cam_idx and frame.get("light_index") == light_idx:
                return index
        return None

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get_full_sample(idx)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Stack the whole split: images [N,H,W,3] (uint8 where
        ``images_uint8``, else float32), pose [N,3,4], intr [N,3,3];
        multi-light datasets add pose_light [N,3,4]. The frames load on
        ``data.num_workers`` threads."""
        samples = self.preload_threading(self.get_full_sample, self.cfg.data.get("num_workers") or 1)
        out: Dict[str, np.ndarray] = {}
        for key in samples[0].keys():
            if key == "idx":
                continue
            name = "images" if key == "image" else key
            stacked = np.stack([np.asarray(s[key]) for s in samples])
            if name == "images" and self.images_uint8 and stacked.dtype != np.uint8:
                stacked = np.clip(stacked * 255.0 + 0.5, 0, 255).astype(np.uint8)
            out[name] = stacked
        return out
