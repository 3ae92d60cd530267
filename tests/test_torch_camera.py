"""The port's camera math (mlinerf_tpu_torch/utils/camera.py) against the
JAX package's (mlinerf_tpu/utils/camera.py): the cases of
tests/test_camera.py, each run through both packages on the same inputs
from a numpy seed, the port held to the JAX result and to the case's own
property; the spherical-cap samplers fed the uniforms JAX draws from its
key. Then the frustum test on a view wider than it is high, where both
packages hold the pixel x against the image height.

Tolerances: 1e-6 against the JAX result (float32; the Lie maps' Taylor
series and the samplers' Rodrigues rotation sum in another order, within
2e-6); the properties at the tests' own bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mlinerf_tpu.utils import camera as jcam
from mlinerf_tpu_torch.utils import camera

TOL = 1e-6
SERIES_TOL = 2e-6


def random_rotation(rng):
    A = rng.standard_normal((3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=tol)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_pose_invert_roundtrip():
    rng = np.random.default_rng(0)
    R, t = random_rotation(rng), rng.standard_normal(3)
    pose = camera.pose_from_Rt(R, t)
    _close(pose, jcam.pose_from_Rt(R, t))
    composed = camera.pose_compose_pair(pose, camera.pose_invert(pose))
    _close(composed, jcam.pose_compose_pair(jcam.pose_from_Rt(R, t), jcam.pose_invert(jcam.pose_from_Rt(R, t))))
    _close(composed[..., :3], np.eye(3), 1e-5)
    _close(composed[..., 3], np.zeros(3), 1e-5)


def test_pose_compose_matches_matrix_product():
    rng = np.random.default_rng(1)
    Rts = [(random_rotation(rng), rng.standard_normal(3)) for _ in range(3)]
    out = camera.pose_compose([camera.pose_from_Rt(R, t) for R, t in Rts])
    _close(out, jcam.pose_compose([jcam.pose_from_Rt(R, t) for R, t in Rts]))

    def to44(p):
        return np.vstack([np.asarray(p), [0, 0, 0, 1]])

    poses = [np.asarray(jcam.pose_from_Rt(R, t)) for R, t in Rts]
    _close(out, (to44(poses[2]) @ to44(poses[1]) @ to44(poses[0]))[:3], 1e-5)
    scaled = camera.pose_scale_center(out, 2.5)
    _close(scaled, jcam.pose_scale_center(jcam.pose_compose([jcam.pose_from_Rt(R, t) for R, t in Rts]), 2.5))


def test_quaternion_roundtrip():
    rng = np.random.default_rng(2)
    R = random_rotation(rng)
    q = camera.R_to_q(_t(R))
    _close(q, jcam.R_to_q(jnp.asarray(R, jnp.float32)))
    _close(camera.q_to_R(q), R, 1e-4)
    q2 = _t(rng.standard_normal(4))
    _close(camera.q_invert(q2), jcam.q_invert(jnp.asarray(q2.numpy())))
    _close(camera.q_product(q, q2), jcam.q_product(jnp.asarray(q.numpy()), jnp.asarray(q2.numpy())))
    # q * q^-1 is the identity quaternion.
    _close(camera.q_product(q2, camera.q_invert(q2)), [1, 0, 0, 0], 1e-6)


def test_quaternion_slerp_endpoints():
    rng = np.random.default_rng(3)
    Ra, Rb = random_rotation(rng), random_rotation(rng)
    ta, tb = rng.standard_normal(3), rng.standard_normal(3)
    pa, pb = camera.pose_from_Rt(Ra, ta), camera.pose_from_Rt(Rb, tb)
    for alpha in (0.0, 1.0):
        p = camera.pose_interpolate(pa, pb, _t([alpha]))
        _close(p, jcam.pose_interpolate(jcam.pose_from_Rt(Ra, ta), jcam.pose_from_Rt(Rb, tb), jnp.asarray([alpha])))
        _close(p, pa if alpha == 0 else pb, 1e-4)


def test_slerp_halfway_angle():
    Rb = camera.angle_to_rotation_matrix(np.pi / 2, "Z")
    _close(Rb, jcam.angle_to_rotation_matrix(np.pi / 2, "Z"))
    for axis in "XY":
        _close(camera.angle_to_rotation_matrix(0.7, axis), jcam.angle_to_rotation_matrix(0.7, axis))
    pa = camera.pose_from_Rt(np.eye(3), np.zeros(3))
    pb = camera.pose_from_Rt(Rb, np.zeros(3))
    mid = camera.pose_interpolate(pa, pb, _t([0.5]))
    _close(mid[..., :3], camera.angle_to_rotation_matrix(np.pi / 4, "Z"), 1e-4)
    _close(camera.rotation_distance(mid[..., :3], Rb), np.pi / 4, 1e-4)
    _close(camera.rotation_distance(mid[..., :3], Rb),
           jcam.rotation_distance(jnp.asarray(mid[..., :3].numpy()), jnp.asarray(Rb.numpy())))


def test_lie_so3_roundtrip():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal(3) * 0.5).astype(np.float32)
    R = camera.so3_to_SO3(_t(w))
    _close(R, jcam.so3_to_SO3(jnp.asarray(w)), SERIES_TOL)
    _close(camera.SO3_to_so3(R), jcam.SO3_to_so3(jnp.asarray(R.numpy())), SERIES_TOL)
    _close(camera.SO3_to_so3(R), w, 1e-4)
    _close(camera.skew_symmetric(_t(w)), jcam.skew_symmetric(jnp.asarray(w)))


def test_se3_roundtrip():
    rng = np.random.default_rng(5)
    wu = rng.standard_normal(6).astype(np.float32) * 0.3
    Rt = camera.se3_to_SE3(_t(wu))
    _close(Rt, jcam.se3_to_SE3(jnp.asarray(wu)), SERIES_TOL)
    _close(camera.SE3_to_se3(Rt), jcam.SE3_to_se3(jnp.asarray(Rt.numpy())), SERIES_TOL)
    _close(camera.SE3_to_se3(Rt), wu, 1e-4)


def test_world_cam_roundtrip():
    rng = np.random.default_rng(6)
    R, t = random_rotation(rng), rng.standard_normal(3)
    X = rng.standard_normal((10, 3)).astype(np.float32)
    pose = camera.pose_from_Rt(R, t)
    X_cam = camera.world2cam(_t(X), pose)
    _close(X_cam, jcam.world2cam(jnp.asarray(X), jcam.pose_from_Rt(R, t)))
    _close(camera.cam2world(X_cam, pose), X, 1e-4)
    intr = _t([[10.0, 0, 3], [0, 12.0, 2], [0, 0, 1]])
    _close(camera.cam2img(X_cam, intr), jcam.cam2img(jnp.asarray(X_cam.numpy()), jnp.asarray(intr.numpy())))


def test_get_center_and_ray_pinhole():
    H, W, f = 4, 6, 10.0
    intr = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    pose = camera.pose_from_Rt(np.eye(3), np.zeros(3))
    center, ray = camera.get_center_and_ray(pose[None], _t(intr)[None], (H, W))
    jcenter, jray = jcam.get_center_and_ray(jcam.pose_from_Rt(np.eye(3), np.zeros(3))[None], jnp.asarray(intr)[None],
                                            (H, W))
    assert center.shape == (1, H * W, 3)
    _close(center, jcenter)
    _close(ray, jray)
    _close(ray[0, 0], np.linalg.inv(intr) @ np.array([0.5, 0.5, 1.0]), 1e-5)


def test_camera_center_of_lights():
    rng = np.random.default_rng(7)
    R, c = random_rotation(rng), rng.standard_normal(3)
    pose = camera.pose_from_Rt(R, -R @ c)
    centers = camera.get_camera_center(pose[None], num_pixels=5)
    _close(centers[0], jcam.get_camera_center(jcam.pose_from_Rt(R, -R @ c), num_pixels=5))
    _close(centers[0], np.broadcast_to(c, (5, 3)), 1e-5)


def _frustum_case(H, W, pts):
    f = 8.0
    intr = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    got = camera.inside_camera_view(_t(intr), camera.pose_from_Rt(np.eye(3), np.zeros(3)), (H, W), _t(pts))
    want = jcam.inside_camera_view(jnp.asarray(intr), jcam.pose_from_Rt(np.eye(3), np.zeros(3)), (H, W),
                                   jnp.asarray(pts, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


def test_inside_camera_view():
    mask = _frustum_case(8, 8, [[0.0, 0.0, 2.0], [0.0, 0.0, -1.0], [100.0, 0.0, 1.0]])
    assert mask.tolist() == [True, False, False]


def test_inside_camera_view_non_square_mirrors_the_reference():
    """On a view of H = 4 rows and W = 12 columns the pixel x (column) is
    held against H, as in the JAX package: a point projecting into column
    6 (inside the image) counts as outside, one in row 2 and column 2
    inside. Both packages agree point by point."""
    H, W, f = 4, 12, 8.0
    # Pixel (x, y) = (f * X / Z + W / 2, f * Y / Z + H / 2) at Z = 1.
    pts = [[(x - W / 2) / f, (y - H / 2) / f, 1.0] for x, y in [(2.0, 2.0), (6.0, 2.0), (11.0, 1.0), (2.0, 3.9)]]
    mask = _frustum_case(H, W, pts)
    assert mask.tolist() == [True, False, False, True]


def _cap_uniforms(key, shape):
    """The (radius, theta) uniforms jax's sample_on_spherical_cap draws
    from ``key``."""
    k_r, k_t = jax.random.split(key)
    return tuple(torch.from_numpy(np.asarray(jax.random.uniform(k, shape))) for k in (k_r, k_t))


def _northern_uniforms(key, shape, rounds):
    """The first draw's and each rejection round's uniforms (fold_in(key,
    i + 1) for round i)."""
    return [_cap_uniforms(key, shape)] + [_cap_uniforms(jax.random.fold_in(key, i + 1), shape) for i in range(rounds)]


def test_sample_on_spherical_cap():
    key = jax.random.PRNGKey(0)
    max_angle = 0.4
    for anchor in ([0.0, 0.0, 1.0], [0.6, 0.0, 0.8], [0.0, -0.8, 0.6]):
        pts = camera.sample_on_spherical_cap(_t(anchor), 2048, max_angle, uniforms=_cap_uniforms(key, (2048,)))
        _close(pts, jcam.sample_on_spherical_cap(key, jnp.asarray(anchor), 2048, max_angle), SERIES_TOL)
        assert pts.shape == (2048, 3)
        _close(torch.linalg.norm(pts, dim=-1), np.ones(2048), 1e-5)
        assert float((pts @ _t(anchor)).min()) >= np.cos(max_angle) - 1e-5
    z = camera.sample_on_spherical_cap(_t([0.0, 0.0, 1.0]), 8192, max_angle, generator=torch.Generator().manual_seed(0))
    u = (z[:, 2].numpy() - np.cos(max_angle)) / (1 - np.cos(max_angle))
    hist, _ = np.histogram(u, bins=8, range=(0, 1))
    assert hist.min() > 0.7 * (8192 / 8) and hist.max() < 1.3 * (8192 / 8)


def test_sample_on_spherical_cap_batched_jit():
    key = jax.random.PRNGKey(3)
    anchors = np.asarray([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8]], np.float32)
    want = jax.jit(lambda k: jcam.sample_on_spherical_cap(k, jnp.asarray(anchors), 16, 0.5))(key)
    pts = camera.sample_on_spherical_cap(_t(anchors), 16, 0.5, uniforms=_cap_uniforms(key, (2, 16)))
    assert pts.shape == (2, 16, 3)
    _close(pts, want, SERIES_TOL)
    _close(torch.linalg.norm(pts, dim=-1), np.ones((2, 16)), 1e-5)


def test_sample_on_spherical_cap_northern():
    key = jax.random.PRNGKey(1)
    a = np.asarray([0.8, 0.0, 0.6], np.float32)
    pts = camera.sample_on_spherical_cap_northern(_t(a), 512, 1.2, uniforms=_northern_uniforms(key, (512,), 8))
    _close(pts, jcam.sample_on_spherical_cap_northern(key, jnp.asarray(a), 512, 1.2), SERIES_TOL)
    assert float(pts[..., 2].min()) >= 0.0
    _close(torch.linalg.norm(pts, dim=-1), np.ones(512), 1e-5)

    away = np.asarray([0.0, 1.0, 0.0], np.float32)
    pts2 = camera.sample_on_spherical_cap_northern(_t(a), 512, 1.0, away_from=_t(away),
                                                   uniforms=_northern_uniforms(key, (512,), 8))
    _close(pts2, jcam.sample_on_spherical_cap_northern(key, jnp.asarray(a), 512, 1.0, away_from=jnp.asarray(away)),
           SERIES_TOL)
    assert (pts2.numpy() @ away <= float(away @ a) + 1e-5).all()

    # away_from == -anchor: every sample but the anchor is invalid, so the
    # lanes fall back to the anchor after the budget.
    pts3 = camera.sample_on_spherical_cap_northern(_t(a), 64, 3.0, away_from=_t(-a), max_reject_count=2,
                                                   uniforms=_northern_uniforms(key, (64,), 2))
    want3 = jcam.sample_on_spherical_cap_northern(key, jnp.asarray(a), 64, 3.0, away_from=-jnp.asarray(a),
                                                  max_reject_count=2)
    _close(pts3, want3, SERIES_TOL)
    assert float(np.mean(np.linalg.norm(pts3.numpy() - a, axis=-1) < 1e-5)) > 0.5
    # From a generator: the same properties.
    pts4 = camera.sample_on_spherical_cap_northern(_t(a), 512, 1.2, generator=torch.Generator().manual_seed(0))
    assert float(pts4[..., 2].min()) >= 0.0
