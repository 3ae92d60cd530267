"""Procedural multi-light synthetic dataset (analytic renderer, no files).

Two scenes, rendered with numpy from a seed: ``sphere`` (one lambertian
sphere with a procedural albedo) and ``cluttered`` (eight spheres with
high-frequency albedos and hard cast shadows). Both give exact intrinsics
(reflectance, shading, image = R*S). With ``data.train.pseudo_label``
enabled, the training split also carries the stage-b pseudo labels of
``pseudo_label_all.npz`` (see :meth:`Dataset.as_arrays`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.data.base import Dataset as BaseDataset
from mlinerf_tpu_torch.pipelines.label_store import load_results_all

SPHERE_RADIUS = 0.45
SPHERE_CENTER = np.zeros(3, np.float32)

# "cluttered" scene: spheres packed inside the unit bounding sphere.
CLUTTERED_SPHERES = np.asarray(
    [
        # cx, cy, cz, radius
        [0.00, 0.00, -0.25, 0.38],   # large base sphere ("ground")
        [0.32, 0.18, 0.22, 0.20],
        [-0.30, 0.25, 0.15, 0.17],
        [-0.05, -0.38, 0.25, 0.15],
        [0.05, 0.42, 0.42, 0.12],
        [0.40, -0.28, 0.35, 0.11],
        [-0.42, -0.15, 0.45, 0.10],
        [0.12, 0.05, 0.58, 0.09],
    ],
    np.float32,
)


def look_at_pose(cam_pos: np.ndarray, target: np.ndarray = None, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World->camera [3,4] pose in CV convention (x right, y down, z forward)."""
    target = target if target is not None else np.zeros(3, np.float32)
    forward = target - cam_pos
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, np.float32)
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(forward, np.asarray([0.0, 1.0, 0.0], np.float32))
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    down = down / np.linalg.norm(down)
    R = np.stack([right, down, forward])  # rows
    t = -R @ cam_pos
    return np.concatenate([R, t[:, None]], axis=-1).astype(np.float32)


def procedural_reflectance(points: np.ndarray) -> np.ndarray:
    """Smooth procedural albedo in [0.1, 0.9] as a function of position."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = 0.5 + 0.4 * np.sin(8 * x) * np.cos(5 * y)
    g = 0.5 + 0.4 * np.sin(6 * y + 1.0)
    b = 0.5 + 0.4 * np.cos(7 * z + 2.0)
    return np.clip(np.stack([r, g, b], axis=-1), 0.1, 0.9).astype(np.float32)


def cluttered_reflectance(points: np.ndarray, obj_idx: np.ndarray) -> np.ndarray:
    """Per-object high-frequency procedural albedo in [0.1, 0.9]."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    k = obj_idx.astype(np.float32)
    r = 0.5 + 0.4 * np.sin((10 + 2 * k) * x + 1.7 * k) * np.cos((7 + k) * y)
    g = 0.5 + 0.4 * np.sin((8 + 3 * k) * y + 0.9 * k + 1.0)
    b = 0.5 + 0.4 * np.cos((12 + 2 * k) * z + 0.5 * k + 2.0)
    return np.clip(np.stack([r, g, b], axis=-1), 0.1, 0.9).astype(np.float32)


def _intersect_spheres(origins: np.ndarray, dirs: np.ndarray, spheres: np.ndarray):
    """Nearest positive ray-sphere hit against a [K,4] sphere list.

    Returns (t [...], obj_idx [...] int32, hit [...] bool)."""
    oc = origins[..., None, :] - spheres[None, ..., :3]  # [...,K,3]
    b = np.sum(dirs[..., None, :] * oc, axis=-1)  # [...,K]
    c = np.sum(oc * oc, axis=-1) - spheres[..., 3] ** 2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    valid = (disc > 0) & (t > 1e-4)
    t = np.where(valid, t, np.inf)
    obj_idx = np.argmin(t, axis=-1).astype(np.int32)
    t_min = np.take_along_axis(t, obj_idx[..., None], axis=-1)[..., 0]
    hit = np.isfinite(t_min)
    return np.where(hit, t_min, 0.0), obj_idx, hit


def _pixel_dirs(pose: np.ndarray, intr: np.ndarray, image_size: Tuple[int, int]):
    H, W = image_size
    R, t = pose[:3, :3], pose[:3, 3]
    cam_center = -R.T @ t
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs_world = (pix @ np.linalg.inv(intr).T) @ R
    dirs_world = dirs_world / np.linalg.norm(dirs_world, axis=-1, keepdims=True)
    return cam_center, dirs_world


def _finish(reflectance, shading, mask, white_background: bool):
    image = reflectance * shading
    bg = 1.0 if white_background else 0.0
    image = image * mask + bg * (1 - mask)
    reflectance = reflectance * mask + bg * (1 - mask)
    shading = shading * mask + bg * (1 - mask)
    return (
        image.astype(np.float32),
        reflectance.astype(np.float32),
        np.repeat(shading, 3, axis=-1).astype(np.float32),
        mask,
    )


def render_cluttered_image(pose: np.ndarray, intr: np.ndarray, light_pos: np.ndarray,
                           image_size: Tuple[int, int], white_background: bool = True):
    """Lambertian multi-sphere render with hard cast shadows.
    Returns (image, reflectance, shading, mask)."""
    spheres = CLUTTERED_SPHERES
    cam_center, dirs_world = _pixel_dirs(pose, intr, image_size)
    origins = np.broadcast_to(cam_center, dirs_world.shape)
    t_hit, obj_idx, hit = _intersect_spheres(origins, dirs_world, spheres)
    points = cam_center + dirs_world * t_hit[..., None]
    normals = (points - spheres[obj_idx, :3]) / spheres[obj_idx, 3:4]
    to_light = light_pos - points
    light_dist = np.linalg.norm(to_light, axis=-1, keepdims=True)
    to_light = to_light / light_dist
    # Hard shadow: test occlusion from just off the surface toward the light.
    t_sh, _, sh_hit = _intersect_spheres(points + normals * 1e-3, to_light, spheres)
    occluded = sh_hit & (t_sh < light_dist[..., 0])
    shading = np.clip(np.sum(normals * to_light, axis=-1, keepdims=True), 0, 1)
    shading = shading * (~occluded[..., None]).astype(np.float32)
    reflectance = cluttered_reflectance(points, obj_idx)
    return _finish(reflectance, shading, hit[..., None].astype(np.float32), white_background)


def render_sphere_image(pose: np.ndarray, intr: np.ndarray, light_pos: np.ndarray,
                        image_size: Tuple[int, int], white_background: bool = True):
    """Lambertian single-sphere render. Returns (image, reflectance, shading,
    mask), each [H,W,3] / [H,W,1] float32 in [0,1]."""
    cam_center, dirs_world = _pixel_dirs(pose, intr, image_size)
    oc = cam_center - SPHERE_CENTER
    b = np.sum(dirs_world * oc, axis=-1)
    c = np.sum(oc * oc) - SPHERE_RADIUS**2
    disc = b**2 - c
    hit = disc > 0
    t_hit = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t_hit > 0
    points = cam_center + dirs_world * t_hit[..., None]
    normals = (points - SPHERE_CENTER) / SPHERE_RADIUS
    to_light = light_pos - points
    to_light = to_light / np.linalg.norm(to_light, axis=-1, keepdims=True)
    shading = np.clip(np.sum(normals * to_light, axis=-1, keepdims=True), 0, 1)
    reflectance = procedural_reflectance(points)
    return _finish(reflectance, shading, hit[..., None].astype(np.float32), white_background)


@register("dataset", "synthetic")
class Dataset(BaseDataset):
    """Procedural multi-light scene.

    Config keys (cfg.data): image sizes per split, ``scene``,
    ``num_cameras``, ``num_lights``, ``load_iid`` per split, ``seed``.
    """

    def __init__(self, cfg, is_inference: bool = False, is_test: bool = False):
        super().__init__(cfg, is_inference=is_inference, is_test=is_test)
        cfg_data = cfg.data
        split_cfg = cfg_data[self.split if self.split in cfg_data else "val"]
        self.H, self.W = split_cfg.image_size
        self.num_cameras = cfg_data.get("num_cameras", 6)
        self.num_lights = cfg_data.get("num_lights", 4)
        self.load_iid = split_cfg.get("load_iid", False)
        self.white_background = cfg_data.get("white_background", True)
        self.scene = cfg_data.get("scene", "sphere")
        if self.scene not in ("sphere", "cluttered"):
            raise ValueError(f"unknown synthetic scene '{self.scene}'")
        seed = cfg_data.get("seed", 0) + (100 if self.split != "train" else 0)
        rng = np.random.default_rng(seed)
        # Cameras on a ring (radius 2.2, slight elevation jitter), lights on a
        # ring of radius 1.8, outside the unit bounding sphere.
        self.list = []
        for ci in range(self.num_cameras):
            for li in range(self.num_lights):
                phi_c = 2 * np.pi * ci / self.num_cameras + rng.uniform(0, 0.2)
                elev_c = rng.uniform(0.2, 0.7)
                cam_pos = 2.2 * np.asarray(
                    [np.cos(phi_c) * np.cos(elev_c), np.sin(phi_c) * np.cos(elev_c), np.sin(elev_c)],
                    np.float32,
                )
                phi_l = 2 * np.pi * li / self.num_lights + rng.uniform(0, 0.3)
                elev_l = rng.uniform(0.3, 0.9)
                light_pos = 1.8 * np.asarray(
                    [np.cos(phi_l) * np.cos(elev_l), np.sin(phi_l) * np.cos(elev_l), np.sin(elev_l)],
                    np.float32,
                )
                self.list.append(dict(camera_index=ci, light_index=li,
                                      cam_pos=cam_pos, pl_pos=light_pos, pl_index=li))
        subset = split_cfg.get("subset")
        if subset:
            idxs = np.linspace(0, len(self.list), subset + 1)[:-1].astype(int)
            self.list = [self.list[i] for i in idxs]
        focal = 1.2 * max(self.H, self.W)
        self.intr = np.asarray(
            [[focal, 0, self.W / 2], [0, focal, self.H / 2], [0, 0, 1]], np.float32
        )
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        pl_cfg = split_cfg.get("pseudo_label") if self.split == "train" else None
        self.pseudo_label = load_results_all(pl_cfg.pt_file) if pl_cfg and pl_cfg.get("enabled") else None

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """The base class's arrays, plus the pseudo labels where they are
        loaded: frame ``i`` reads camera ``str(i)`` of the store (the
        ``unpair`` setting keys its cameras by frame) and its light ``"0"``
        (the frame's own light), as pseudo_ref [N,H,W,3], pseudo_sha and
        pseudo_visibility_certainty [N,H,W,1]."""
        out = super().as_arrays()
        if self.pseudo_label is not None:
            nodes = [self.pseudo_label[str(i)] for i in range(len(self))]

            def stacked(get):
                return np.stack([get(n) for n in nodes]).astype(np.float32)

            out["pseudo_ref"] = stacked(lambda n: n["pseudo_reflectance"])
            out["pseudo_sha"] = stacked(lambda n: n["0"]["pseudo_shading_gamma"])
            out["pseudo_visibility_certainty"] = stacked(lambda n: n["0"]["visibility_certainty"])
        return out

    def get_light(self, idx: int) -> np.ndarray:
        """w2c pose of the light (rotation = identity, translation = -pl)."""
        pl = self.list[idx]["pl_pos"]
        R = np.eye(3, dtype=np.float32)
        return np.concatenate([R, (-R @ pl)[:, None]], axis=-1).astype(np.float32)

    def get_full_sample(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        frame = self.list[idx]
        pose = look_at_pose(frame["cam_pos"])
        render = render_cluttered_image if self.scene == "cluttered" else render_sphere_image
        image, ref, sha, _ = render(
            pose, self.intr, frame["pl_pos"], (self.H, self.W), self.white_background
        )
        sample = dict(idx=idx, image=image, intr=self.intr, pose=pose,
                      pose_light=self.get_light(idx))
        if self.load_iid:
            sample["Ref"] = ref
            sample["Sha"] = sha
            sample["Res"] = np.zeros_like(ref)
        self._cache[idx] = sample
        return sample
