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


# ---------------------------------------------------------------------------
# Pose interpolation (the relighting video's camera and light paths)
# ---------------------------------------------------------------------------


def pose_interpolate(pose_a, pose_b, alpha):
    """Slerp of the rotations and lerp of the translations of two poses
    [...,3,4]; ``alpha`` [...,1] is the fraction of the way to ``pose_b``."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    R = q_to_R(q_interpolate(R_to_q(R_a), R_to_q(R_b), alpha))
    t = (1 - alpha[..., None]) * t_a + alpha[..., None] * t_b
    return torch.cat([R, t], dim=-1)


def q_to_R(q):
    """Unit quaternions [...,4] (w, x, y, z) -> rotations [...,3,3]."""
    qa, qb, qc, qd = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (qc**2 + qd**2), 2 * (qb * qc - qa * qd), 2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb**2 + qd**2), 2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd), 1 - 2 * (qb**2 + qc**2)], dim=-1),
    ], dim=-2)


def R_to_q(R, eps=1e-6):
    """Rotations [...,3,3] -> quaternions [...,4] (w, x, y, z), each
    component's magnitude from the diagonal (clamped at ``eps``) and its
    sign from the off-diagonal differences."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = R00 + R11 + R22
    qa = 0.5 * torch.sqrt(torch.clamp(1 + trace, min=eps))
    qb = torch.sign(R21 - R12) * 0.5 * torch.sqrt(torch.clamp(1 + R00 - R11 - R22, min=eps))
    qc = torch.sign(R02 - R20) * 0.5 * torch.sqrt(torch.clamp(1 - R00 + R11 - R22, min=eps))
    qd = torch.sign(R10 - R01) * 0.5 * torch.sqrt(torch.clamp(1 - R00 - R11 + R22, min=eps))
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_interpolate(q1, q2, alpha, eps=1e-8):
    """Spherical linear interpolation of quaternions [...,4] by ``alpha``
    [...,1]: q1 is flipped onto q2's hemisphere first, and (nearly)
    aligned quaternions are interpolated linearly. Returns unit
    quaternions."""
    cos_angle = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q1 = torch.where(cos_angle < 0, -q1, q1)
    theta = torch.arccos(torch.clamp(torch.abs(cos_angle), 0.0, 1.0 - eps))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-5
    safe_sin = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w1 = torch.where(near, 1 - alpha, torch.sin((1 - alpha) * theta) / safe_sin)
    w2 = torch.where(near, alpha, torch.sin(alpha * theta) / safe_sin)
    q = w1 * q1 + w2 * q2
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
