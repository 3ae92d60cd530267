"""Dataset base: the whole training split exported as stacked arrays.

Training keeps the split on the device as stacked tensors and picks images
and rays there (trainers/base.py ``sample_batch``), so a dataset's job is to
render or load every frame once and stack them (``as_arrays``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class Dataset:
    """Base dataset. Subclasses populate ``self.list`` (frame metadata) and
    implement ``get_full_sample``."""

    def __init__(self, cfg, is_inference: bool = False, is_test: bool = False):
        self.cfg = cfg
        self.split = "test" if is_test else ("val" if is_inference else "train")
        self.is_inference = is_inference

    def __len__(self):
        return len(self.list)

    def get_full_sample(self, idx: int) -> Dict[str, np.ndarray]:
        """Eval-style sample: full image + camera (+light), regardless of split."""
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get_full_sample(idx)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Stack the whole split: images [N,H,W,3], pose [N,3,4], intr
        [N,3,3]; multi-light datasets add pose_light [N,3,4]."""
        samples = [self.get_full_sample(i) for i in range(len(self))]
        out: Dict[str, np.ndarray] = {}
        for key in samples[0].keys():
            if key == "idx":
                continue
            out["images" if key == "image" else key] = np.stack([np.asarray(s[key]) for s in samples])
        return out
