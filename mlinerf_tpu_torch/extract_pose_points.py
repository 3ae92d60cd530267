"""The camera and light centres of a dataset as a PLY point cloud, a check
of the pose conventions of an annotation file:
``python -m mlinerf_tpu_torch.extract_pose_points --config <yaml>
[--split train|val] [--output poses.ply]``.

Cameras are blue (0, 0, 255) and lights yellow (255, 200, 0), each centre
``-R^T t`` of its world->camera pose, in the dataset's order; the file is
the JAX package's ``scripts/extract_pose_points.py``'s, byte for byte.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Camera and light centres to a PLY point cloud")
    parser.add_argument("--config", required=True)
    parser.add_argument("--split", default="train", choices=["train", "val"])
    parser.add_argument("--output", default="poses.ply")
    args = parser.parse_args(argv)
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops.mesh import save_ply

    cfg = Config(args.config)
    ds = resolve("dataset", cfg.data.type)(cfg, is_inference=(args.split == "val"))
    pts, colors = [], []
    for i in range(len(ds)):
        s = ds.get_full_sample(i)
        R, t = s["pose"][:3, :3], s["pose"][:3, 3]
        pts.append(-R.T @ t)
        colors.append([0, 0, 255])
        if "pose_light" in s:
            Rl, tl = s["pose_light"][:3, :3], s["pose_light"][:3, 3]
            pts.append(-Rl.T @ tl)
            colors.append([255, 200, 0])
    verts = np.stack(pts).astype(np.float32)
    save_ply(args.output, verts, np.zeros((0, 3), np.int64), np.asarray(colors, np.uint8))
    print(f"wrote {args.output} ({len(verts)} points)")
    return verts


if __name__ == "__main__":
    main()
