"""Fibonacci-spiral hemisphere directions, their unwrap onto a square tile
and the rotation of +z onto a normal: the indirect-light probe's geometry.

The spiral and the unwrap's coordinates are host numpy in float64, as in
the JAX package. The unwrap's nearest spiral point per pixel is found in
column chunks of the [N, S*S] distance matrix (float64, numpy's first
minimum on ties), so the default 300 x 300 probe never holds the 65 GB
matrix the JAX package builds, and the index and mask are its, bit for
bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Distance-matrix elements per chunk of columns (float64, two buffers of
# them: 2 GiB on the card, 512 MiB on the host).
CHUNK_ELEMENTS = {"cuda": 2**27, "cpu": 2**25}


def _spiral(N: int):
    indices = np.arange(N, dtype=np.float64) / 2.0  # half sphere
    phi = np.pi * (5.0**0.5 - 1.0)  # golden angle
    lat = np.arccos(np.clip(1 - 2 * indices / (N - 1), -1, 1))
    return lat, indices * phi


def hemisphere_spiral(N: int) -> np.ndarray:
    """N unit vectors [N,3] float32 evenly covering the +z hemisphere (the
    golden-angle spiral)."""
    lat, lon = _spiral(N)
    return np.stack([np.sin(lat) * np.cos(lon), np.sin(lat) * np.sin(lon), np.cos(lat)], axis=-1).astype(np.float32)


def square_interpolation(N: int, device=None) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Nearest-neighbour unwrap of the spiral onto an S x S square,
    S = int(sqrt(N)): (index [S*S] int64 into the spiral's points, mask
    [S*S] of the pixels inside the projected disc, (S, S)).

    The distances are float64 on ``device`` (the CPU by default), each an
    exactly rounded subtract, square and add as numpy computes them, in
    chunks of CHUNK_ELEMENTS / N pixels."""
    device = torch.device(device or "cpu")
    lat, lon = _spiral(N)
    S = int(N**0.5)
    px, py = lat * np.cos(lon), lat * np.sin(lon)
    gx = np.linspace(px.min(), px.max(), S)
    gy = np.linspace(py.max(), py.min(), S)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    fx, fy = GX.ravel(), GY.ravel()
    step = max(CHUNK_ELEMENTS[device.type] // N, 1)
    px_t, py_t = (torch.from_numpy(a).to(device)[:, None] for a in (px, py))
    fx_t, fy_t = (torch.from_numpy(a).to(device)[None, :] for a in (fx, fy))
    index = torch.empty(S * S, dtype=torch.int64, device=device)
    for c0 in range(0, S * S, step):
        d2 = px_t - fx_t[:, c0:c0 + step]
        d2.mul_(d2)
        dy = py_t - fy_t[:, c0:c0 + step]
        d2.add_(dy.mul_(dy))  # each op rounded on its own: no fused multiply-add
        index[c0:c0 + step] = torch.argmin(d2, dim=0)
    mask = np.sqrt(fx**2 + fy**2) < lat.max()
    return index.cpu().numpy(), mask, (S, S)


def rotation_from_z(v):
    """Rotations [...,3,3] taking +z onto each vector v [...,3] (normalized
    first): Rodrigues' formula, the identity where v is +z and a half turn
    about x where it is -z."""
    v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)
    z = v.new_tensor([0.0, 0.0, 1.0]).expand_as(v)
    axis = torch.linalg.cross(z, v)
    axis_norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    fallback = v.new_tensor([1.0, 0.0, 0.0]).expand_as(v)
    axis = torch.where(axis_norm > 1e-12, axis / torch.where(axis_norm > 0, axis_norm, torch.ones_like(axis_norm)),
                       fallback)
    zeros = torch.zeros_like(v[..., 0])
    ax, ay, az = axis.unbind(-1)
    skew = torch.stack([torch.stack([zeros, -az, ay], dim=-1),
                        torch.stack([az, zeros, -ax], dim=-1),
                        torch.stack([-ay, ax, zeros], dim=-1)], dim=-2)
    cos_a = torch.clamp(v[..., 2], -1.0, 1.0)
    angle = torch.arccos(cos_a)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand_as(skew)
    skew2 = (skew[..., :, :, None] * skew[..., None, :, :]).sum(-2)  # skew @ skew in float32
    R = eye + skew * torch.sin(angle)[..., None, None] + skew2 * (1 - torch.cos(angle))[..., None, None]
    R_anti = torch.diag(v.new_tensor([1.0, -1.0, -1.0])).expand_as(skew)
    R = torch.where((cos_a >= 1.0)[..., None, None], eye, R)
    return torch.where((cos_a <= -1.0)[..., None, None], R_anti, R)
