"""Camera math: pose algebra, quaternions, the SO(3)/SE(3) Lie maps,
world/camera/image transforms, per-pixel rays, the frustum test and the
spherical-cap samplers.

Poses are [...,3,4] world->camera matrices [R|t], as in the JAX package.
Random draws come from an explicit ``torch.Generator`` or are handed in as
uniforms.
"""

from __future__ import annotations

import math

import torch


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def pose_from_Rt(R=None, t=None):
    """A [...,3,4] float32 pose from a rotation [...,3,3] and/or a
    translation [...,3] (identity rotation or zero translation where one is
    None)."""
    if R is None:
        t = _f32(t)
        R = torch.eye(3, device=t.device).expand(*t.shape[:-1], 3, 3)
    elif t is None:
        R = _f32(R)
        t = R.new_zeros(R.shape[:-1])
    R = _f32(R)
    t = _f32(t, R.device)
    return torch.cat([R, t[..., None]], dim=-1)


def pose_compose_pair(pose_a, pose_b):
    """The pose x -> pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return torch.cat([R_b @ R_a, R_b @ t_a + t_b], dim=-1)


def pose_compose(pose_list):
    """The poses applied in order: pose_list[0] first."""
    pose_new = pose_list[0]
    for p in pose_list[1:]:
        pose_new = pose_compose_pair(pose_new, p)
    return pose_new


def pose_scale_center(pose, scale):
    """The pose with its translation scaled (t' = scale * t)."""
    return torch.cat([pose[..., :3], pose[..., 3:] * scale], dim=-1)


def pose_invert(pose):
    """Invert a rigid pose: (R,t) -> (R^T, -R^T t)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = -R_inv @ t
    return torch.cat([R_inv, t_inv], dim=-1)


def to_hom(X):
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X, pose):
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2img(X, intr):
    return X @ intr.transpose(-1, -2)


def img2cam(X, intr):
    # inv_ex: the inverse without inv's error check, which would wait for
    # the device (and so could not run in a captured step).
    return X @ torch.linalg.inv_ex(intr).inverse.transpose(-1, -2)


def cam2world(X, pose):
    return to_hom(X) @ pose_invert(pose).transpose(-1, -2)


def angle_to_rotation_matrix(a, axis: str):
    """Rotation [...,3,3] by the angle ``a`` about the X, Y or Z axis."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    a = _f32(a)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack([torch.stack([torch.cos(a), -torch.sin(a), zero], dim=-1),
                     torch.stack([torch.sin(a), torch.cos(a), zero], dim=-1),
                     torch.stack([zero, zero, one], dim=-1)], dim=-2)
    return torch.roll(M, (roll, roll), dims=(-2, -1))


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


def q_invert(q):
    """The inverse of quaternions [...,4]: the conjugate over the squared
    norm."""
    qa, qb, qc, qd = q.unbind(-1)
    return torch.stack([qa, -qb, -qc, -qd], dim=-1) / torch.sum(q * q, dim=-1, keepdim=True)


def q_product(q1, q2):
    """The Hamilton product of quaternions [...,4] (w, x, y, z)."""
    a1, b1, c1, d1 = q1.unbind(-1)
    a2, b2, c2, d2 = q2.unbind(-1)
    return torch.stack([a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
                        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
                        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
                        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2], dim=-1)


# ---------------------------------------------------------------------------
# Lie algebra (SO(3)/SE(3)): the exponential and logarithm maps, their
# coefficients as Taylor series of 11 terms (float32, as the JAX package).
# ---------------------------------------------------------------------------


def skew_symmetric(w):
    """[...,3] -> the cross-product matrices [...,3,3]."""
    w0, w1, w2 = w.unbind(-1)
    zero = torch.zeros_like(w0)
    return torch.stack([torch.stack([zero, -w2, w1], dim=-1),
                        torch.stack([w2, zero, -w0], dim=-1),
                        torch.stack([-w1, w0, zero], dim=-1)], dim=-2)


def _taylor(x, first_denom, factors, nth=10):
    """sum_i (-1)^i x^(2i) / denom_i with denom_0 = first_denom and
    denom_i = denom_{i-1} * factors(i)."""
    ans = torch.zeros_like(x)
    denom = first_denom
    for i in range(nth + 1):
        if i > 0:
            denom *= factors(i)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def _taylor_A(x, nth=10):
    """sin(x) / x."""
    return _taylor(x, 1.0, lambda i: (2 * i) * (2 * i + 1), nth)


def _taylor_B(x, nth=10):
    """(1 - cos(x)) / x^2."""
    return _taylor(x, 2.0, lambda i: (2 * i + 1) * (2 * i + 2), nth)


def _taylor_C(x, nth=10):
    """(x - sin(x)) / x^3."""
    return _taylor(x, 6.0, lambda i: (2 * i + 2) * (2 * i + 3), nth)


def so3_to_SO3(w):
    """Axis-angle vectors [...,3] -> rotations [...,3,3] (Rodrigues)."""
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + _taylor_A(theta) * wx + _taylor_B(theta) * (wx @ wx)


def SO3_to_so3(R, eps=1e-7):
    """Rotations [...,3,3] -> axis-angle vectors [...,3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.remainder(torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))[..., None, None], math.pi)
    lnR = 1 / (2 * _taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def se3_to_SE3(wu):
    """Twists [...,6] (w, u) -> poses [...,3,4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    A, B, C = _taylor_A(theta), _taylor_B(theta), _taylor_C(theta)
    R = eye + A * wx + B * (wx @ wx)
    V = eye + B * wx + C * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt, eps=1e-8):
    """Poses [...,3,4] -> twists [...,6] (w, u)."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    A, B = _taylor_A(theta), _taylor_B(theta)
    invV = eye - 0.5 * wx + (1 - A / (2 * B)) / (theta**2 + eps) * (wx @ wx)
    return torch.cat([w, (invV @ t)[..., 0]], dim=-1)


# ---------------------------------------------------------------------------
# The frustum test and the spherical-cap samplers
# ---------------------------------------------------------------------------


def rotation_distance(R1, R2, eps=1e-7):
    """The angle [...] of the rotation between R1 and R2 [...,3,3]."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def inside_camera_view(intr, pose, image_size, pts, z_min=0.0):
    """Whether world points [...,3] lie in front of the camera (z > z_min)
    and project inside the image: bool [...].

    As in the JAX package, the pixel x is held against ``image_size[0]``
    and y against ``image_size[1]``; with the (H, W) order of
    :func:`get_center_and_ray` that is x against H, so on a view wider than
    it is high the columns from H on count as outside."""
    pts_cam = world2cam(pts, pose)
    z_ok = pts_cam[..., 2] > z_min
    pix = cam2img(pts_cam, intr)
    pts_2d = pix[..., :2] / pix[..., 2:]
    x, y = pts_2d[..., 0], pts_2d[..., 1]
    in_range = (x >= 0.5) & (x <= image_size[0] - 0.5) & (y >= 0.5) & (y <= image_size[1] - 0.5)
    return in_range & z_ok


def sample_on_spherical_cap(anchor, N: int, max_angle, generator=None, uniforms=None):
    """N unit vectors per anchor, uniform on the spherical cap of half-angle
    ``max_angle`` around each unit vector ``anchor`` [...,3]: [...,N,3].

    A uniform point of the unit disk is lifted to the cap around +z by the
    area-preserving map, then rotated onto the anchor by the Rodrigues
    rotation built from ``anchor x z`` (an anchor of -z has none). The
    uniforms are ``uniforms = (u_radius, u_theta)`` [...,N] each, or drawn
    from ``generator``. The rotation is applied as float32 products and
    sums, never through TF32 (the JAX package pins this product to full
    precision)."""
    shape = (*anchor.shape[:-1], N)
    if uniforms is None:
        uniforms = tuple(torch.rand(shape, generator=generator, device=anchor.device) for _ in range(2))
    radius, u_theta = (_f32(u, anchor.device) for u in uniforms)
    theta = u_theta * (2.0 * math.pi)
    x = torch.sqrt(radius) * torch.cos(theta)
    y = torch.sqrt(radius) * torch.sin(theta)
    h = 1.0 - torch.cos(_f32(max_angle, anchor.device))
    k = h * radius
    s = torch.sqrt(h * (2.0 - k))
    points = torch.stack([s * x, s * y, 1.0 - k], dim=-1)  # [...,N,3] around +z
    ref_z = anchor.new_tensor([0.0, 0.0, 1.0]).expand_as(anchor)
    ss_v = skew_symmetric(-torch.linalg.cross(anchor, ref_z))
    denom = 1.0 + (anchor * ref_z).sum(-1)
    ss_v2 = (ss_v[..., :, :, None] * ss_v[..., None, :, :]).sum(-2)  # ss_v @ ss_v in float32
    R = torch.eye(3, dtype=anchor.dtype, device=anchor.device) + ss_v + ss_v2 / denom[..., None, None]
    return (points[..., :, None, :] * R[..., None, :, :]).sum(-1)


def sample_on_spherical_cap_northern(anchor, N: int, max_angle, away_from=None, max_reject_count: int = 8,
                                     generator=None, uniforms=None):
    """Cap samples (:func:`sample_on_spherical_cap`) kept to z >= 0 and,
    with ``away_from`` [...,3], to the anchor's side of it
    (cos(away, sample) <= cos(away, anchor)). A first draw, then
    ``max_reject_count`` rounds, each re-drawing every lane and taking the
    new sample where the current one is invalid; lanes still invalid after
    the last round become the anchor. ``uniforms`` is a list of
    ``max_reject_count + 1`` (u_radius, u_theta) pairs, the first for the
    first draw; else they come from ``generator``."""

    def invalid_mask(points):
        bad = points[..., 2] < 0.0
        if away_from is not None:
            cos_ab = (away_from * anchor).sum(-1, keepdim=True)
            cos_ac = (away_from[..., None, :] * points).sum(-1)
            bad = bad | (cos_ab < cos_ac)
        return bad

    draws = uniforms if uniforms is not None else [None] * (max_reject_count + 1)
    if len(draws) != max_reject_count + 1:
        raise ValueError(f"{len(draws)} pairs of uniforms for {max_reject_count + 1} draws")
    points = sample_on_spherical_cap(anchor, N, max_angle, generator, draws[0])
    for draw in draws[1:]:
        fresh = sample_on_spherical_cap(anchor, N, max_angle, generator, draw)
        points = torch.where(invalid_mask(points)[..., None], fresh, points)
    return torch.where(invalid_mask(points)[..., None], anchor[..., None, :].expand_as(points), points)
