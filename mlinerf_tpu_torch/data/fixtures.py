"""Datasets in the paper's and the NeRF family's file layouts, made without
their images.

The ReNe, MLI-synthetic, NRHints, NeRF-synthetic and LLFF images cannot be
shipped, so the tests and the GPU smoke write stand-ins in the same layouts:
the ReNe layout takes its cameras, lights and intrinsics from an annotation
directory such as ``dataset_rene/savannah``; the MLI-synthetic and NRHints
layouts put cameras on a ring around the origin with a point light per
frame; the NeRF-synthetic layout (lego's) puts them on a sphere of radius 4
with RGBA frames; the LLFF layout (fern's) faces forward, with
``poses_bounds.npy`` and PNG frames (the real captures are JPEG). Every
image is a render of the procedural ``cluttered`` scene
(``data/synthetic.py``), with sensor noise drawn from ``seed``, written by
``save(path, uint8 [H,W,C])``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from mlinerf_tpu_torch.data.blender import gl_to_cv, invert_pose
from mlinerf_tpu_torch.data.synthetic import look_at_pose, render_cluttered_image
from mlinerf_tpu_torch.utils.image_io import save_png

Saver = Callable[[str, np.ndarray], None]
# The cluttered scene fills the unit sphere; a ReNe scene fits a box of
# about 1.3 x 0.9 x 0.5 around the origin.
RENE_SCENE_SCALE = 0.4
# ReNe frames render at a quarter of the raw size and are repeated up to
# it (a 1440x1080 render takes seconds on a host core).
RENE_RENDER_DIV = 4


def camera_filters(h: int, rng: np.random.Generator) -> np.ndarray:
    """Per-row PNG filter types as an encoder with adaptive filtering
    leaves them on camera frames: mostly Paeth, every type present."""
    filters = rng.choice(5, size=h, p=[0.05, 0.1, 0.15, 0.1, 0.6]).astype(np.uint8)
    filters[:5] = np.arange(5)
    return filters


def filtered_saver(seed: int = 0) -> Saver:
    """``save`` that writes with :func:`camera_filters`, all five types."""
    rng = np.random.default_rng(seed)

    def save(path, img):
        save_png(path, img, filters=camera_filters(img.shape[0], rng))

    return save


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _render(pose_w2c, intr, light_pos, raw_hw, scale, render_div, bg, rng):
    """The cluttered scene seen by ``pose_w2c`` (world units divided by
    ``scale``), rendered at 1/``render_div`` of ``raw_hw`` and repeated up
    to it, lit by a point light with some ambient light. Returns (image,
    reflectance, shading, mask), float32 at ``raw_hw``."""
    H, W = raw_hw
    h, w = -(-H // render_div), -(-W // render_div)
    pose = pose_w2c.copy()
    pose[:, 3] /= scale
    small = intr.copy()
    small[:2] /= render_div
    _, ref, sha, mask = render_cluttered_image(pose, small, light_pos / scale, (h, w), white_background=False)
    sha = 0.2 + 0.8 * sha
    img = ref * sha * mask + bg * (1 - mask)

    def up(x):
        return np.repeat(np.repeat(x, render_div, 0), render_div, 1)[:H, :W]

    noise = rng.normal(0.0, 1.5 / 255.0, (H, W, 1)).astype(np.float32)
    return up(img) + noise, up(ref), up(sha), up(mask)


def write_rene(root: str, annotation_dir: str, cameras: int = 4, lights: int = 4,
               raw_size: Optional[Tuple[int, int]] = None, extra_splits: Dict[str, int] = None,
               save: Optional[Saver] = None, seed: int = 0) -> Dict[str, str]:
    """A ReNe scene under ``root``: ``train_transforms.json`` with the
    frames of ``cameras`` x ``lights`` of ``annotation_dir``'s train split
    (spread over its camera and light indices), ``val_transforms.json`` with
    every frame of its val split (savannah's holds ``c25l10``), and for each
    ``extra_splits`` entry (e.g. ``{"test_custom": 2}``) that many frames of
    ``<name>_transforms.json``. Images go to each frame's ``file_path`` at
    ``raw_size`` = (W, H) (default: the annotation's), intrinsics scaled to
    match. Returns {split: annotation path}."""
    save = save or filtered_saver(seed)
    rng = np.random.default_rng(seed)

    def meta_of(split):
        with open(os.path.join(annotation_dir, f"{split}_transforms.json")) as f:
            return json.load(f)

    train = meta_of("train")
    cams = sorted({f["camera_index"] for f in train["frames"]})
    lits = sorted({f["light_index"] for f in train["frames"]})
    pick_c = {cams[i] for i in np.linspace(0, len(cams) - 1, cameras).round().astype(int)}
    pick_l = {lits[i] for i in np.linspace(0, len(lits) - 1, lights).round().astype(int)}
    splits = {"train": dict(train, frames=[f for f in train["frames"]
                                           if f["camera_index"] in pick_c and f["light_index"] in pick_l])}
    splits["val"] = meta_of("val")
    for name, count in (extra_splits or {}).items():
        meta = meta_of(name)
        splits[name] = dict(meta, frames=meta["frames"][:count])
    os.makedirs(root, exist_ok=True)
    written, out = set(), {}
    for split, meta in splits.items():
        raw_w, raw_h = raw_size or (meta["w"], meta["h"])
        sx, sy = raw_w / meta["w"], raw_h / meta["h"]
        meta = dict(meta, w=raw_w, h=raw_h, fl_x=meta["fl_x"] * sx, cx=meta["cx"] * sx, sk_x=meta["sk_x"] * sx,
                    fl_y=meta["fl_y"] * sy, cy=meta["cy"] * sy)
        intr = np.asarray([[meta["fl_x"], meta["sk_x"], meta["cx"]],
                           [meta.get("sk_y", 0.0), meta["fl_y"], meta["cy"]], [0, 0, 1]], np.float32)
        for frame in meta["frames"]:
            path = os.path.normpath(os.path.join(root, frame["file_path"]))
            if path in written:
                continue
            pose = invert_pose(gl_to_cv(np.asarray(frame["transform_matrix"], np.float32))[:3])
            light = np.asarray(frame["transform_matrix_light"], np.float32)[:3, 3]
            img, _, _, _ = _render(pose, intr, light, (raw_h, raw_w), RENE_SCENE_SCALE, RENE_RENDER_DIV, 0.15, rng)
            save(path, _to_uint8(img))
            written.add(path)
        out[split] = os.path.join(root, f"{split}_transforms.json")
        with open(out[split], "w") as f:
            json.dump(meta, f)
    return out


def _ring_frames(count: int, lights: int, rng: np.random.Generator, offset: float) -> List[dict]:
    frames = []
    for i in range(count):
        phi = 2 * np.pi * i / count + offset
        elev = rng.uniform(0.3, 0.7)
        cam = 2.4 * np.asarray([np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev), np.sin(elev)], np.float32)
        w2c = look_at_pose(cam)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = w2c[:, :3].T
        c2w[:3, 3] = cam
        li = i % lights
        phi_l = 2 * np.pi * li / lights + 0.4
        light = 1.9 * np.asarray([np.cos(phi_l) * 0.6, np.sin(phi_l) * 0.6, 0.8], np.float32)
        frames.append(dict(transform_matrix=gl_to_cv(c2w).tolist(), pl_pos=light.tolist(), pl_index=li))
    return frames


def write_point_light(root: str, image_size: int = 512, train: int = 4, val: int = 2, lights: int = 2,
                      source: str = "mli", save: Optional[Saver] = None, seed: int = 0) -> Dict[str, str]:
    """A point-light scene under ``root``, ``transforms_{train,val}.json``
    with ``pl_pos`` per frame. ``source="mli"``: the MLI-synthetic layout,
    ``camera_angle_x`` and RGBA ``<file_path>{Img,Ref,Sha,Res}.png`` (alpha
    = coverage); ``source="nrhints"``: NRHints', ``camera_intrinsics`` and
    one RGB ``<file_path><file_ext>`` per frame. Returns {split:
    annotation path}."""
    save = save or filtered_saver(seed)
    rng = np.random.default_rng(seed)
    angle_x = 0.69
    focal = 0.5 * image_size / np.tan(0.5 * angle_x)
    intr = np.asarray([[focal, 0, image_size / 2], [0, focal, image_size / 2], [0, 0, 1]], np.float32)
    out = {}
    for split, count, offset in (("train", train, 0.0), ("val", val, 0.3)):
        frames = _ring_frames(count, lights, rng, offset)
        for i, frame in enumerate(frames):
            pose = invert_pose(gl_to_cv(np.asarray(frame["transform_matrix"], np.float32))[:3])
            img, ref, sha, mask = _render(pose, intr, np.asarray(frame["pl_pos"], np.float32),
                                          (image_size, image_size), 1.0, 1, 0.0, rng)
            if source == "nrhints":
                frame.update(file_path=f"{split}/{i:03d}", file_ext=".png")
                save(os.path.join(root, frame["file_path"] + frame["file_ext"]), _to_uint8(img))
                continue
            frame["file_path"] = f"{split}/{i:03d}_"
            alpha = _to_uint8(mask)
            res = np.zeros_like(ref)
            for key, value in (("Img", img), ("Ref", ref), ("Sha", sha), ("Res", res)):
                rgb = _to_uint8(np.broadcast_to(value, ref.shape))
                save(os.path.join(root, frame["file_path"] + key + ".png"), np.concatenate([rgb, alpha], -1))
        meta = dict(frames=frames)
        if source == "nrhints":
            meta["camera_intrinsics"] = [image_size / 2, image_size / 2, float(focal), float(focal)]
        else:
            meta["camera_angle_x"] = angle_x
        out[split] = os.path.join(root, f"transforms_{split}.json")
        os.makedirs(root, exist_ok=True)
        with open(out[split], "w") as f:
            json.dump(meta, f)
    return out


def write_nerf_synthetic(root: str, image_size: int = 800, train: int = 4, val: int = 2, render_div: int = 4,
                         save: Optional[Saver] = None, seed: int = 0) -> Dict[str, str]:
    """A NeRF-synthetic scene under ``root`` in lego's layout:
    ``transforms_{train,val}.json`` with ``camera_angle_x`` and each
    frame's OpenGL ``transform_matrix``, and RGBA ``<file_path>.png`` at
    ``image_size`` (lego's raw 800x800; alpha = coverage) on cameras at
    radius 4 around the origin (lego's). Returns {split: annotation path}."""
    save = save or filtered_saver(seed)
    rng = np.random.default_rng(seed)
    angle_x = 0.6911112070083618  # lego's
    focal = 0.5 * image_size / np.tan(0.5 * angle_x)
    intr = np.asarray([[focal, 0, image_size / 2], [0, focal, image_size / 2], [0, 0, 1]], np.float32)
    os.makedirs(root, exist_ok=True)
    out = {}
    for split, count, offset in (("train", train, 0.0), ("val", val, 0.3)):
        frames = []
        for i in range(count):
            phi, elev = 2 * np.pi * i / count + offset, rng.uniform(0.2, 0.8)
            cam = 4.0 * np.asarray([np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev), np.sin(elev)], np.float32)
            w2c = look_at_pose(cam)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3], c2w[:3, 3] = w2c[:, :3].T, cam
            light = cam + np.asarray([0.0, 0.0, 2.0], np.float32)
            img, _, _, mask = _render(w2c, intr, light, (image_size, image_size), 1.0, render_div, 0.0, rng)
            frame = dict(file_path=f"./{split}/r_{i}", transform_matrix=gl_to_cv(c2w).tolist())
            save(os.path.join(root, frame["file_path"] + ".png"),
                 np.concatenate([_to_uint8(img), _to_uint8(mask)], -1))
            frames.append(frame)
        out[split] = os.path.join(root, f"transforms_{split}.json")
        with open(out[split], "w") as f:
            json.dump(dict(camera_angle_x=angle_x, frames=frames), f)
    return out


def write_llff(root: str, raw_size: Tuple[int, int] = (1008, 756), frames: int = 9, render_div: int = 4,
               save: Optional[Saver] = None, seed: int = 0) -> str:
    """A forward-facing scene under ``root`` in fern's layout:
    ``poses_bounds.npy`` ([N,17]: the [down, right, back, t] columns, then
    (H, W, focal) at ``raw_size`` = (W, H), then the near and far bounds)
    and ``images/IMG_<i>.png``. The cameras sit on a small grid 4 units in
    front of the scene, all looking along -z, so every ray goes forward
    after the loader's recentring (NDC needs z > 0). Returns ``root``."""
    save = save or filtered_saver(seed)
    rng = np.random.default_rng(seed)
    raw_w, raw_h = raw_size
    focal = 0.8 * raw_w
    intr = np.asarray([[focal, 0, raw_w / 2], [0, focal, raw_h / 2], [0, 0, 1]], np.float32)
    right, up, back = np.eye(3, dtype=np.float32)
    rows = []
    for i in range(frames):
        cam = np.asarray([0.3 * (i % 3 - 1), 0.2 * (i // 3 - 1), 4.0], np.float32) + rng.normal(0, 0.02, 3)
        c2w_cv = np.stack([right, -up, -back, cam], axis=1)  # [right, down, forward, t]
        img, _, _, _ = _render(invert_pose(c2w_cv), intr, cam + np.asarray([1.0, 2.0, 0.0], np.float32),
                               (raw_h, raw_w), 1.0, render_div, 0.15, rng)
        save(os.path.join(root, "images", f"IMG_{4026 + i}.png"), _to_uint8(img))
        stored = np.stack([-up, right, back, cam], axis=1)
        hwf = np.asarray([[raw_h], [raw_w], [focal]], np.float64)
        near = 2.4 + rng.uniform(0, 0.2)
        rows.append(np.concatenate([np.concatenate([stored, hwf], axis=1).reshape(-1), [near, 6.0 + near]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.asarray(rows, np.float64))
    return root
