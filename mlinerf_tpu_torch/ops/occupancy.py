"""Occupancy grid for the coarse samples (opt-in, ``model.render.occupancy``).

A dense grid (default 64^3) marks the cells whose |SDF| at the cell centre
lies within ``band_cells`` cells of the surface; training refreshes it from
the SDF every ``update_every`` steps. Each ray then marches ``march_bins``
fixed bins between near and far, reads the grid at each bin (nearest cell)
and draws its coarse samples by inverse CDF from that occupancy profile,
with a ``floor`` so that empty space keeps some samples. Off by default:
the reference samples uniformly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mlinerf_tpu_torch.utils import sampling as samp


def grid_coordinates(resolution: int, range_min: float, range_max: float) -> np.ndarray:
    """Cell-centre world coordinates of the lattice, [R^3, 3] float32 (x
    slowest, z fastest)."""
    centers = (np.arange(resolution) + 0.5) / resolution
    xs = range_min + centers * (range_max - range_min)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)


def occupancy_from_sdf(sdf_values: torch.Tensor, resolution: int, range_min: float, range_max: float,
                       band_cells: float = 3.0) -> torch.Tensor:
    """[R,R,R] float32: 1 where |sdf| < band_cells cells, else 0.
    sdf_values [R^3] in ``grid_coordinates`` order."""
    band = band_cells * ((range_max - range_min) / resolution)
    occ = (torch.abs(sdf_values) < band).to(torch.float32)
    return occ.reshape(resolution, resolution, resolution)


def lookup(grid: torch.Tensor, points: torch.Tensor, range_min: float, range_max: float) -> torch.Tensor:
    """Nearest-cell occupancy of points [..., 3] -> [...]; points outside
    the range clamp to the border cells."""
    R = grid.shape[0]
    x01 = (points - range_min) / (range_max - range_min)
    idx = torch.clamp((x01 * R).to(torch.int32), 0, R - 1).long()
    flat = (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]
    return grid.reshape(-1)[flat.reshape(-1)].reshape(points.shape[:-1])


def occupancy_coarse_dists(grid: torch.Tensor, center, ray_unit, near, far, intvs: int,
                           range_min: float, range_max: float, march_bins: int = 128, floor: float = 0.02,
                           stratified: bool = False, generator: Optional[torch.Generator] = None,
                           jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse distances [B,R,intvs,1], ascending, drawn from the rays'
    occupancy profiles. center/ray_unit [B,R,3]; near/far [B,R,1].

    With ``stratified`` each distance moves by (u - 0.5) march bins and is
    clamped to [near, far]; u [B,R,intvs,1] is ``jitter`` where given, else
    drawn from ``generator``."""
    t = (torch.arange(march_bins, dtype=torch.float32, device=near.device) + 0.5) / march_bins  # [M]
    d = near * (1 - t) + far * t  # [B,R,M]
    R = grid.shape[0]
    scale = R / (range_max - range_min)
    flat = torch.zeros(d.shape, dtype=torch.int64, device=d.device)
    for c in range(3):
        p_c = center[..., c:c + 1] + ray_unit[..., c:c + 1] * d
        i_c = torch.clamp(((p_c - range_min) * scale).to(torch.int32), 0, R - 1)
        flat = flat * R + i_c
    occ = grid.reshape(-1)[flat.reshape(-1)].reshape(d.shape)
    te = torch.arange(march_bins + 1, dtype=torch.float32, device=near.device) / march_bins
    edges = near * (1 - te) + far * te  # [B,R,M+1]
    dists = samp.sample_dists_from_pdf(edges[..., None], occ + floor, intvs)  # [B,R,intvs,1]
    if stratified:
        if jitter is None:
            jitter = torch.rand(dists.shape, generator=generator, device=dists.device)
        spacing = (far[..., None] - near[..., None]) / march_bins
        dists = torch.minimum(torch.maximum(dists + (jitter - 0.5) * spacing, near[..., None]), far[..., None])
    return torch.sort(dists, dim=-2).values
