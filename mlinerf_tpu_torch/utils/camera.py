"""Camera math: world/camera/image transforms and per-pixel rays.

Poses are [...,3,4] world->camera matrices [R|t], as in the JAX package.
"""

from __future__ import annotations

import torch


def pose_invert(pose):
    """Invert a rigid pose: (R,t) -> (R^T, -R^T t)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = -R_inv @ t
    return torch.cat([R_inv, t_inv], dim=-1)


def to_hom(X):
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def img2cam(X, intr):
    return X @ torch.linalg.inv(intr).transpose(-1, -2)


def cam2world(X, pose):
    return to_hom(X) @ pose_invert(pose).transpose(-1, -2)


def get_center_and_ray(pose, intr, image_size):
    """Camera centers and (non-unit) pixel rays in world space.

    pose [B,3,4], intr [B,3,3], image_size (H, W) ints.
    Returns center [B,HW,3], ray [B,HW,3] (depth-1 rays).
    """
    H, W = image_size
    y = torch.arange(H, dtype=torch.float32, device=pose.device) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=pose.device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    xy_grid = torch.stack([X, Y], dim=-1).reshape(-1, 2)  # [HW,2]
    xy_grid = xy_grid.expand(pose.shape[0], *xy_grid.shape)
    grid_3D = img2cam(to_hom(xy_grid), intr)  # [B,HW,3]
    center_3D = torch.zeros_like(grid_3D)
    grid_3D = cam2world(grid_3D, pose)
    center_3D = cam2world(center_3D, pose)
    return center_3D, grid_3D - center_3D


def get_camera_center(pose, num_pixels: int):
    """Camera (or light) center in world space, repeated per pixel:
    [B,3,4] -> [B,num_pixels,3]."""
    center = torch.zeros(pose.shape[0], num_pixels, 3, dtype=torch.float32, device=pose.device)
    return cam2world(center, pose)


def get_3D_points_from_dist(center, ray_unit, dist):
    """x = c + d*v over a samples axis: [...,3],[...,3],[...,N,1] -> [...,N,3]."""
    return center[..., None, :] + ray_unit[..., None, :] * dist


def convert_NDC(center, ray, intr, near: float = 1.0):
    """Shift ray origins to the plane z = ``near`` and project origins and
    directions to normalized device coordinates (LLFF's forward-facing
    scenes). center, ray [B,R,3]; intr [B,3,3]. Every ray must have z > 0."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center.unbind(-1)
    rx, ry, rz = ray.unbind(-1)
    scale_x = (intr[..., 0, 0] / intr[..., 0, 2])[..., None]
    scale_y = (intr[..., 1, 1] / intr[..., 1, 2])[..., None]
    center_ndc = torch.stack([scale_x * (cx / cz), scale_y * (cy / cz), 1 - 2 * near / cz], dim=-1)
    ray_ndc = torch.stack([scale_x * (rx / rz - cx / cz), scale_y * (ry / rz - cy / cz), 2 * near / cz], dim=-1)
    return center_ndc, ray_ndc
