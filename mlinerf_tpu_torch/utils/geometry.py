"""Ray / bounding-sphere intersection."""

from __future__ import annotations

import torch


def intersect_with_sphere(center, ray_unit, radius: float = 1.0):
    """Ray-sphere intersection distances (NaN where the ray misses).
    Returns (dist_near, dist_far), [...,1] each."""
    ctc = torch.sum(center * center, dim=-1, keepdim=True)
    ctv = torch.sum(center * ray_unit, dim=-1, keepdim=True)
    sq = torch.sqrt(ctv**2 - (ctc - radius**2))  # NaN when negative
    return -ctv - sq, -ctv + sq


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
