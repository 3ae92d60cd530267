"""Ray / bounding-volume intersection and sphere tracing."""

from __future__ import annotations

import functools
from typing import Callable

import torch


def intersect_with_sphere(center, ray_unit, radius: float = 1.0):
    """Ray-sphere intersection distances (NaN where the ray misses).
    Returns (dist_near, dist_far), [...,1] each."""
    ctc = torch.sum(center * center, dim=-1, keepdim=True)
    ctv = torch.sum(center * ray_unit, dim=-1, keepdim=True)
    sq = torch.sqrt(ctv**2 - (ctc - radius**2))  # NaN when negative
    return -ctv - sq, -ctv + sq


def intersect_aabb(origins, directions, aabb, max_bound: float = 1e10):
    """Slab-test ray/AABB intersection. aabb: [6] = [x_min, y_min, z_min,
    x_max, y_max, z_max]. Returns (t_min [...,1], t_max [...,1], outside
    [...,1] bool)."""
    if not isinstance(aabb, torch.Tensor):
        aabb = _box(tuple(float(v) for v in aabb), origins.device)
    tx_min = (aabb[:3] - origins) / directions
    tx_max = (aabb[3:] - origins) / directions
    t_min = torch.amax(torch.minimum(tx_min, tx_max), dim=-1, keepdim=True)
    t_max = torch.amin(torch.maximum(tx_min, tx_max), dim=-1, keepdim=True)
    t_min = torch.clamp(t_min, 0, max_bound)
    t_max = torch.clamp(t_max, 0, max_bound)
    return t_min, t_max, t_max <= t_min


def dist_bounds_sphere(center, ray_unit, radius: float = 1.0,
                       dummy_near: float = 1.0, dummy_far: float = 1.2):
    """Near/far distances against a bounding sphere. Rays that miss get the
    dummy bounds (1, 1.2) and ``outside`` True. Returns ([...,1] x3)."""
    near, far = intersect_with_sphere(center, ray_unit, radius=radius)
    near = torch.maximum(near, torch.zeros_like(near))  # keeps NaN
    outside = torch.isnan(near)
    near = torch.where(outside, torch.full_like(near, dummy_near), near)
    far = torch.where(outside, torch.full_like(far, dummy_far), far)
    return near, far, outside


@functools.lru_cache(maxsize=None)
def _box(aabb, device: torch.device) -> torch.Tensor:
    """A config's box as a float32 tensor on ``device``, copied there once
    (a step replayed from a CUDA graph copies nothing from the host)."""
    return torch.tensor(aabb, dtype=torch.float32, device=device)


def dist_bounds_aabb(center, ray_unit, aabb, dummy_near: float = 1.0, dummy_far: float = 1.2):
    """Near/far distances against a box; rays that miss it get the dummy
    bounds and ``outside`` True."""
    near, far, outside = intersect_aabb(center, ray_unit, aabb)
    near = torch.where(outside, torch.full_like(near, dummy_near), near)
    far = torch.where(outside, torch.full_like(far, dummy_far), far)
    return near, far, outside


@torch.no_grad()
def sphere_tracing_intersection(sdf_fn: Callable, center, ray_unit, near, far,
                                num_iters: int = 20, dist_start=None):
    """Fixed-iteration sphere tracing: ``dist += sdf`` while the ray stays
    inside ``[near, far]``. A ray's mask latches off for good once ``dist``
    leaves the range; the other rays keep marching.

    sdf_fn: points [...,3] -> sdf [...,1]. Returns (dist [...,1] clipped to
    [near, far], pts [...,3], mask [...,1] bool: True where the trace stayed
    inside the range, i.e. converged onto a surface)."""
    dist = near if dist_start is None else dist_start
    mask = torch.ones_like(dist, dtype=torch.bool)
    for _ in range(num_iters):
        sdfs = sdf_fn(center + ray_unit * dist)
        dist = torch.where(mask, dist + sdfs, dist)
        mask = mask & (dist <= far) & (dist >= near)
    dist = torch.minimum(torch.maximum(dist, near), far)
    return dist, center + ray_unit * dist, mask
