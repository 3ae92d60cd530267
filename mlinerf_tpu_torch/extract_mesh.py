"""Mesh extraction CLI: ``python -m mlinerf_tpu_torch.extract_mesh --config
<yaml> [--logdir DIR] [--checkpoint PATH] [--output_file PLY] [--resolution
N] [--block_res N] [--textured] [--keep_lcc] [--device cuda|cpu] [--a.b=value
...]``.

The arguments of the JAX package's ``scripts/extract_mesh.py``, plus
``--device`` (CUDA unless the CPU is asked for). Loads ``--checkpoint``
(default: the ``latest_checkpoint.txt`` pointer in the logdir) at its
trained iteration, evaluates the SDF of its evaluation parameters (the EMA
copy where EMA is on) on a ``resolution``³ lattice in ``block_res``³
blocks, and writes an ASCII PLY (default ``<logdir>/mesh.ply``), with
vertex colours under ``--textured``. The lattice spans
``data.bounding_box_aabb`` for a box-bounded dataset, else [-1, 1]³.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Extract mesh (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--output_file", default=None)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--block_res", type=int, default=128)
    parser.add_argument("--textured", action="store_true")
    parser.add_argument("--keep_lcc", action="store_true",
                        help="keep only the largest connected component (the reference's filter_lcc)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser.parse_known_args(argv)


def main(argv=None):
    """Extract and write the mesh; returns (PLY path, verts, faces, colors)."""
    args, cfg_cmd = parse_args(argv)
    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops import mesh as mesh_ops
    from mlinerf_tpu_torch.pipelines import mesh_extract

    logdir = args.logdir or os.path.join("logs", os.path.splitext(os.path.basename(args.config))[0])
    checkpoint = args.checkpoint or os.path.join(logdir, "latest_checkpoint.txt")
    cfg = Config(args.config, cli_args=cfg_cmd)
    # The mesh needs no pseudo labels and no warm start.
    if cfg.model.get("use_pre_trained"):
        cfg.model.pop("use_pre_trained")
    if cfg.data.train.get("pseudo_label"):
        cfg.data.train.pseudo_label.enabled = False
    trainer = resolve("trainer", cfg.trainer.type)(cfg, is_inference=True, logdir=logdir, device=args.device)
    if not trainer.load_checkpoint(checkpoint, resume=False, load_opt=False):
        raise FileNotFoundError(f"no checkpoint at {checkpoint}")

    if cfg.data.get("bounding_type") == "box" and cfg.data.get("bounding_box_aabb"):
        aabb = cfg.data.bounding_box_aabb
        bounds_min, bounds_max = aabb[:3], aabb[3:]
    else:
        bounds_min, bounds_max = (-1, -1, -1), (1, 1, 1)

    texture_fn = mesh_extract.trainer_texture_fn(trainer) if args.textured else None
    verts, faces, colors = mesh_extract.extract_mesh(
        mesh_extract.trainer_sdf_fn(trainer), bounds_min, bounds_max, resolution=args.resolution,
        block_res=args.block_res, texture_fn=texture_fn, filter_lcc=args.keep_lcc, device=trainer.device)
    out = args.output_file or os.path.join(logdir, "mesh.ply")
    mesh_ops.save_ply(out, verts, faces, colors)
    print(f"Extracted {len(verts)} vertices / {len(faces)} faces -> {out}", flush=True)
    return out, verts, faces, colors


if __name__ == "__main__":
    main()
