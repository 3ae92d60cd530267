"""Block-wise SDF mesh extraction: lattice blocks -> the SDF on the device
in fixed-size chunks -> marching tetrahedra per block on the host ->
concatenated, bounding-sphere filtered, welded, rescaled to the world
frame, with optional vertex colours from the radiance field.

The lattice is numpy's float64 ``linspace`` cast to float32, as the JAX
package builds it (a float32 ``torch.linspace`` rounds some points to the
neighbouring float, which would move the vertices by an ulp).
"""

from __future__ import annotations

import numpy as np
import torch

from mlinerf_tpu_torch.models.fields import NeuralRGB
from mlinerf_tpu_torch.ops import mesh as mesh_ops
from mlinerf_tpu_torch.utils.misc import get_device


def lattice_blocks(bounds_min, bounds_max, resolution: int, block_res: int = 128):
    """Yield (origin index (i0, j0, k0), grid points [bx,by,bz,3] float32)
    covering the lattice. Neighbouring blocks share one layer of samples,
    so the surface is seamless across them."""
    bounds_min = np.asarray(bounds_min, np.float32)
    bounds_max = np.asarray(bounds_max, np.float32)
    xs = np.linspace(bounds_min[0], bounds_max[0], resolution)
    ys = np.linspace(bounds_min[1], bounds_max[1], resolution)
    zs = np.linspace(bounds_min[2], bounds_max[2], resolution)
    step = block_res - 1
    for i0 in range(0, resolution - 1, step):
        for j0 in range(0, resolution - 1, step):
            for k0 in range(0, resolution - 1, step):
                i1 = min(i0 + block_res, resolution)
                j1 = min(j0 + block_res, resolution)
                k1 = min(k0 + block_res, resolution)
                X, Y, Z = np.meshgrid(xs[i0:i1], ys[j0:j1], zs[k0:k1], indexing="ij")
                yield (i0, j0, k0), np.stack([X, Y, Z], axis=-1).astype(np.float32)


def _evaluate(fn, points: np.ndarray, chunk: int, device) -> np.ndarray:
    """``fn`` over host points [N,3] in ``chunk``-point pieces on the
    device, without autograd; one copy back at the end."""
    x = torch.from_numpy(points).to(device)
    with torch.no_grad():
        out = torch.cat([fn(x[c0:c0 + chunk]) for c0 in range(0, len(x), chunk)])
    return out.cpu().numpy()


def extract_mesh(
    sdf_fn,
    bounds_min=(-1, -1, -1),
    bounds_max=(1, 1, 1),
    resolution: int = 256,
    block_res: int = 128,
    filter_lcc: bool = False,
    sphere_center=(0.0, 0.0, 0.0),
    sphere_radius: float = 1.0,
    chunk: int = 262144,
    texture_fn=None,
    filter_bounding_sphere: bool = True,
    device=None,
):
    """Extract the zero set of ``sdf_fn``.

    Args:
        sdf_fn: points [N,3] -> SDF [N], torch on ``device`` (CUDA unless the
            CPU is asked for).
        sphere_center/radius: world-frame rescale of the output vertices
            (undoes the dataset normalization).
        texture_fn: optional points [V,3] -> RGB [V,3] in [0,1], for vertex
            colours.
    Returns:
        (verts [V,3] float32, faces [T,3] int64, colors [V,3] uint8 or None)
    """
    device = get_device(device)
    bounds_min = np.asarray(bounds_min, np.float32)
    bounds_max = np.asarray(bounds_max, np.float32)
    cell = (bounds_max - bounds_min) / (resolution - 1)
    soups = []
    for (i0, j0, k0), pts in lattice_blocks(bounds_min, bounds_max, resolution, block_res):
        field = _evaluate(sdf_fn, pts.reshape(-1, 3), chunk, device).reshape(pts.shape[:3])
        tris = mesh_ops.marching_tets(field, 0.0)
        if len(tris) == 0:
            continue
        # Grid-index coordinates -> world coordinates within this block.
        origin = bounds_min + np.asarray([i0, j0, k0], np.float32) * cell
        soups.append(tris * cell[None, None, :] + origin[None, None, :])
    if not soups:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), None
    soup = np.concatenate(soups, axis=0)
    if filter_bounding_sphere:
        soup = soup[np.linalg.norm(soup.mean(axis=1), axis=-1) <= 1.0]
    verts, faces = mesh_ops.weld_vertices(soup)
    if filter_lcc and len(faces):
        verts, faces = filter_largest_cc(verts, faces)
    # Undo the dataset normalization: world = v * radius + center.
    verts_world = verts * sphere_radius + np.asarray(sphere_center, np.float32)
    colors = None
    if texture_fn is not None and len(verts):
        rgb = _evaluate(texture_fn, np.ascontiguousarray(verts), chunk, device)
        colors = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    return verts_world, faces, colors


def filter_largest_cc(verts, faces):
    """Keep the connected component with the largest surface area (the
    reference's ``filter_largest_cc``, trimesh ``split`` + area argmax):
    components over the vertex-edge graph, per-component triangle areas,
    then vertices and faces reindexed."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    verts = np.asarray(verts)
    faces = np.asarray(faces)
    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 0]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    graph = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    _, roots = connected_components(graph, directed=False)

    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    area_by_root = np.zeros(n)
    np.add.at(area_by_root, roots[faces[:, 0]], areas)
    best = int(np.argmax(area_by_root))

    keep_v = roots == best
    new_index = np.full(n, -1, np.int64)
    new_index[keep_v] = np.arange(int(keep_v.sum()))
    keep_f = keep_v[faces[:, 0]]
    return verts[keep_v], new_index[faces[keep_f]]


def _eval_cond(trainer):
    it = trainer.current_iteration
    cond = trainer.make_cond(it)
    cond["max_levels"] = trainer.static_max_levels_for(it)
    return cond


def trainer_sdf_fn(trainer):
    """points [N,3] -> SDF [N] of the trainer's evaluation parameters (the
    EMA copy where EMA is on) at its current iteration."""
    model, cond = trainer.eval_model(), _eval_cond(trainer)

    def fn(pts):
        return model.sdf_only(pts[None], cond)[0, :, 0]

    return fn


def trainer_texture_fn(trainer):
    """points [N,3] -> RGB [N,3] probe for vertex colours: each vertex is
    viewed head-on (ray = -normal, the normal from the 4- or 6-tap SDF
    gradient), lit by a headlight one unit along the normal (the
    light-conditioned heads), with the zero appearance embedding where
    embeddings are on. Intrinsic network modes without an rgb head give the
    reflectance."""
    model, cond = trainer.eval_model(), _eval_cond(trainer)

    def fn(pts):
        p = pts[None]
        sdfs, feats = model.neural_sdf(p, level_mask=cond.get("level_mask"), max_levels=cond.get("max_levels"))
        gradients, _ = model.compute_gradients(p, cond, training=False, sdf=sdfs)
        normals = gradients / (torch.linalg.norm(gradients, dim=-1, keepdim=True) + 1e-12)
        app = model.get_appearance_embedding(None, 1, p.device)[0]  # [1,D] or None
        app = None if app is None else app[:, None].expand(*p.shape[:-1], app.shape[-1])
        if isinstance(model.neural_rgb, NeuralRGB):
            return model.neural_rgb(p, normals, -normals, feats, app=app)[0]
        heads = model.neural_rgb(p, normals, -normals, feats, p + normals, app=app)
        return heads["rgb" if "rgb" in heads else "o_r"][0]

    return fn
