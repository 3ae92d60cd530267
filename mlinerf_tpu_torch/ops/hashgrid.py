"""Multiresolution hash-grid encoding.

Levels whose dense grid fits the table are indexed densely
(``ix + R*(iy + R*iz)``); larger levels use the Instant-NGP spatial hash
``ix ^ iy*2654435761 ^ iz*805459861 (mod T)`` with uint32 wrap-around. Each
level is its own table (a separate parameter), so each level's gradient is a
buffer of that level's size. The 8-corner gather of a level goes through
``hashgrid_scatter.take_rows``, whose backward is the hand-written CUDA
scatter-add on the card.

Each level's features are computed in float32 from the table's values and
rounded to the table's dtype; levels are concatenated in that dtype and the
caller casts the result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mlinerf_tpu_torch.ops.hashgrid_scatter import take_rows

# Primes of the Instant-NGP spatial hash (first coordinate unhashed).
_PRIMES = (1, 2654435761, 805459861)
_UINT32_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multiresolution hash encoding."""

    num_levels: int = 16
    features_per_level: int = 8
    log2_hashmap_size: int = 22
    min_logres: int = 5
    max_logres: int = 11
    range_min: float = -2.0
    range_max: float = 2.0
    dtype: str = "float32"

    @property
    def growth_rate(self) -> float:
        r_min, r_max = 2**self.min_logres, 2**self.max_logres
        if self.num_levels == 1:
            return 1.0
        return float(np.exp((np.log(r_max) - np.log(r_min)) / (self.num_levels - 1)))

    @property
    def resolutions(self) -> Tuple[int, ...]:
        """Per-level grid resolutions: floor(r_min * g^lv) + 1 (numpy float64,
        as the JAX package computes them)."""
        r_min = 2**self.min_logres
        g = self.growth_rate
        return tuple(int(np.floor(r_min * g**lv)) + 1 for lv in range(self.num_levels))

    @property
    def table_sizes(self) -> Tuple[int, ...]:
        """Entries per level: dense when it fits, else the hash-table size."""
        T = 2**self.log2_hashmap_size
        return tuple(res**3 if res**3 <= T else T for res in self.resolutions)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.table_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_tables(spec: HashGridSpec, generator: torch.Generator, scale: float = 1e-4):
    """Per-level tables [size_l, F], Uniform(-scale, scale) (Instant-NGP
    default), drawn in float32 on the CPU and cast to the table dtype."""
    return [
        ((torch.rand(size, spec.features_per_level, generator=generator) * 2 - 1) * scale)
        .to(spec.torch_dtype)
        for size in spec.table_sizes
    ]


def active_levels_to_mask(active_levels: int, num_levels: int) -> np.ndarray:
    """[L] float32 mask with ones on the first ``active_levels`` levels."""
    return (np.arange(num_levels) < active_levels).astype(np.float32)


def level_corners(x01: torch.Tensor, spec: HashGridSpec, lv: int):
    """Corner rows and trilinear weights of one level.

    x01: [P,3] points normalized to [0,1]. Returns (idx [8,P] int32 row
    indices into the level's table, weights [8,P] float32).
    """
    res = float(spec.resolutions[lv])
    c = torch.arange(8, device=x01.device)
    corners = torch.stack([(c >> 2) & 1, (c >> 1) & 1, c & 1], dim=1)  # [8,3] (dx, dy, dz)
    p = x01 * (res - 1.0)
    cell = torch.clamp(torch.floor(p), 0.0, res - 2.0)
    frac = torch.clamp(p - cell, 0.0, 1.0)
    icell = cell.to(torch.int64)
    ix, iy, iz = (icell[:, a][None] + corners[:, a:a + 1] for a in range(3))  # [8,P]
    wx, wy, wz = (torch.where(corners[:, a:a + 1] == 1, frac[:, a][None], 1.0 - frac[:, a][None])
                  for a in range(3))
    weights = wx * wy * wz
    size = spec.table_sizes[lv]
    if spec.resolutions[lv] ** 3 <= size:
        r = spec.resolutions[lv]
        idx = ix + r * (iy + r * iz)
    else:
        # uint32 products, emulated in int64 and wrapped before the XOR.
        idx = (ix * _PRIMES[0]) ^ ((iy * _PRIMES[1]) & _UINT32_MASK) ^ ((iz * _PRIMES[2]) & _UINT32_MASK)
        idx = idx % size
    return idx.to(torch.int32), weights


def encode(tables: Sequence[torch.Tensor], points: torch.Tensor, spec: HashGridSpec,
           level_mask: Optional[Sequence[float]] = None, max_levels: Optional[int] = None):
    """Encode 3D points into concatenated per-level features.

    Args:
        tables: per-level [size_l, F] tables.
        points: [..., 3] points in world units (normalized with
            ``spec.range_min/max``).
        level_mask: optional [L] coarse-to-fine mask (0/1 per level).
        max_levels: optional level cap: levels beyond it are not gathered
            and their features are zero.
    Returns:
        features [..., L*F] in the tables' dtype.
    """
    lead_shape = points.shape[:-1]
    x = points.reshape(-1, 3).float()
    P = x.shape[0]
    F = spec.features_per_level
    x01 = (x - spec.range_min) / (spec.range_max - spec.range_min)
    active = spec.num_levels if max_levels is None else min(int(max_levels), spec.num_levels)
    outs = []
    for lv in range(active):
        idx, weights = level_corners(x01, spec, lv)
        feats = take_rows(tables[lv], idx.reshape(-1)).reshape(8, P, F)
        # Round the weights to the table dtype, combine in float32, round once.
        w = weights.to(feats.dtype).float()
        out_l = (feats.float() * w[..., None]).sum(dim=0).to(feats.dtype)  # [P,F]
        if level_mask is not None and float(level_mask[lv]) != 1.0:
            out_l = out_l * float(level_mask[lv])
        outs.append(out_l)
    if active < spec.num_levels:
        outs.append(torch.zeros(P, (spec.num_levels - active) * F, dtype=outs[0].dtype, device=x.device))
    return torch.cat(outs, dim=-1).reshape(*lead_shape, spec.num_levels * F)
