"""The indirect-light probe: what a sparse grid of surface points sees.

For one view, the surface points come from the blended depth of a full
render and their normals from its composited gradient. At every
``int(probe_resolution * grid_fraction)``-th pixel of each axis a
Fibonacci hemisphere of ``probe_resolution**2`` secondary rays is rotated
onto the outward normal and rendered through the model's ``render_chunk``
(lit from the view's light with a light-conditioned model). Rays whose hit
points leave the camera's frustum are zeroed, and each hemisphere is
unwrapped onto a square tile whose pixels outside the disc are 1.0; the
tiles form the mosaic. Everything is a forward pass (no autograd).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mlinerf_tpu_torch.trainers.base import outputs_to_maps
from mlinerf_tpu_torch.utils import camera, hemisphere


@torch.no_grad()
def indirect_light_probe(trainer, data: Dict[str, np.ndarray], image_size, probe_resolution: int = 300,
                         grid_fraction: float = 0.3, num_rays_chunk: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The indirect-light mosaic of one view.

    ``trainer``: a Lumen or Neuralangelo trainer with its weights loaded;
    ``data``: pose [1,3,4], intr [1,3,3] (and pose_light [1,3,4]) as numpy;
    ``image_size``: (H, W). The secondary rays go in chunks of
    ``num_rays_chunk`` (default: ``model.render.rand_rays_val``). Returns
    ``indirect_rgb`` [Gh*S, Gw*S, 3] float32 (S = int(probe_resolution)),
    the probed ``grid_rows`` and ``grid_cols`` and the view's ``rgb_map``
    [1,H,W,3]."""
    H, W = image_size
    N = probe_resolution**2
    device = trainer.device
    # 1. The primary render: surface points from the blended depth.
    raw = trainer.render_image(data, image_size)
    maps = outputs_to_maps(raw, data, image_size)
    pose = torch.as_tensor(np.asarray(data["pose"]), device=device)
    intr = torch.as_tensor(np.asarray(data["intr"]), device=device)
    center, ray = camera.get_center_and_ray(pose, intr, (H, W))
    ray_norm = torch.linalg.norm(ray, dim=-1, keepdim=True)
    dist = torch.as_tensor(raw["depth"], device=device) * ray_norm
    inter_pts = (center + ray / ray_norm * dist).reshape(H, W, 3)
    normals = torch.as_tensor(raw["gradient"], device=device).reshape(H, W, 3)

    # 2. The probe grid.
    skip = max(int(probe_resolution * grid_fraction), 1)
    ii = list(range(skip // 2, H, skip))
    jj = list(range(skip // 2, W, skip))
    rows, cols = torch.tensor(ii, device=device), torch.tensor(jj, device=device)
    sel_pts = inter_pts[rows][:, cols]  # [Gh,Gw,3]
    sel_nrm = normals[rows][:, cols]  # outward normals

    # 3. Hemisphere rays rotated onto each normal (float32 products, no TF32).
    sphere = torch.from_numpy(hemisphere.hemisphere_spiral(N)).to(device)  # [N,3]
    R = hemisphere.rotation_from_z(sel_nrm)  # [Gh,Gw,3,3]
    dirs = (R[:, :, None, :, :] * sphere[None, None, :, None, :]).sum(-1)  # [Gh,Gw,N,3]
    Gh, Gw = dirs.shape[:2]
    dirs = dirs.reshape(1, -1, 3)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = sel_pts[:, :, None, :].expand(Gh, Gw, N, 3).reshape(1, -1, 3)

    # 4. The secondary rays through the model's chunked render.
    chunk = int(num_rays_chunk or trainer.num_val_rays())
    it = trainer.current_iteration
    cond = trainer.make_cond(it)
    cond["max_levels"] = trainer.static_max_levels_for(it)
    model = trainer.eval_model()
    pts_light = None
    if "pose_light" in data and trainer._needs_light():
        pose_light = torch.as_tensor(np.asarray(data["pose_light"]), device=device)
        pts_light = camera.get_camera_center(pose_light, num_pixels=1).expand_as(dirs)
    rgbs, depths = [], []
    for c0 in range(0, dirs.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        kwargs = {} if pts_light is None else {"pts_light": pts_light[:, sl]}
        out = model.render_chunk(origins[:, sl], dirs[:, sl], cond, **kwargs)
        rgbs.append(out["rgb"])
        depths.append(out["depth"])
    rgb = torch.cat(rgbs, dim=1)  # [1, Gh*Gw*N, 3]
    depth_sec = torch.cat(depths, dim=1)

    # 5. Zero the rays whose hit points leave the frustum.
    in_view = camera.inside_camera_view(intr, pose, (H, W), origins + dirs * depth_sec)
    rgb = torch.where(in_view[..., None], rgb, torch.zeros_like(rgb))

    # 6. Unwrap each hemisphere onto a square tile, and the mosaic.
    index, mask, (S, _) = hemisphere.square_interpolation(N, device=device)
    tiles = rgb.reshape(Gh, Gw, N, 3)[:, :, torch.from_numpy(index).to(device)]  # [Gh,Gw,S*S,3]
    tiles[:, :, torch.from_numpy(~mask).to(device)] = 1.0
    mosaic = tiles.reshape(Gh, Gw, S, S, 3).permute(0, 2, 1, 3, 4).reshape(Gh * S, Gw * S, 3)
    return dict(indirect_rgb=mosaic.cpu().numpy(), grid_rows=ii, grid_cols=jj, rgb_map=maps.get("rgb_map"))
