"""The port's ray geometry (mlinerf_tpu_torch/utils/geometry.py) against the
JAX package's: sphere tracing an analytic sphere SDF, with and without a
start distance and with rays that miss, and the box bounds. Inputs are
made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlinerf_tpu.utils import geometry as jax_geometry
from mlinerf_tpu_torch.utils import geometry

AABB = np.asarray([-0.66, -0.516, -0.18, 0.66, 0.42, 0.3], np.float32)


def _rays(n=512, seed=0):
    """Cameras on a radius-2.5 shell aimed near the origin: most rays hit
    the radius-0.5 sphere, the widest ones miss it."""
    rng = np.random.default_rng(seed)
    center = rng.normal(size=(1, n, 3))
    center = (2.5 * center / np.linalg.norm(center, axis=-1, keepdims=True)).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, (1, n, 3))
    ray = target - center
    ray_unit = (ray / np.linalg.norm(ray, axis=-1, keepdims=True)).astype(np.float32)
    return center, ray_unit


@pytest.mark.parametrize("start", ["near", "dist_start"])
def test_sphere_tracing_matches_jax(start):
    """Continuous outputs within 1e-4 (measured: 1.6e-5 on one grazing ray
    of 512 with a start distance, at dist 3.16, where 20 dependent steps of
    float32 norms that round differently add up; at most 3.8e-6 on the
    other rays); the latched mask is bitwise equal. Both hits and misses
    occur."""
    center, ray_unit = _rays()
    near_np, far_np, _ = (np.asarray(a) for a in jax_geometry.dist_bounds_sphere(center, ray_unit, 1.0))
    dist_start = None if start == "near" else (near_np + 0.3 * (far_np - near_np)).astype(np.float32)

    def jsdf(p):
        return jnp.linalg.norm(p, axis=-1, keepdims=True) - 0.5

    def tsdf(p):
        return torch.linalg.norm(p, dim=-1, keepdim=True) - 0.5

    want = jax_geometry.sphere_tracing_intersection(
        jsdf, center, ray_unit, near_np, far_np,
        dist_start=None if dist_start is None else jnp.asarray(dist_start))
    t = torch.from_numpy
    got = geometry.sphere_tracing_intersection(
        tsdf, t(center), t(ray_unit), t(near_np), t(far_np),
        dist_start=None if dist_start is None else t(dist_start))
    for g, w, name in zip(got[:2], want[:2], ("dist", "pts")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=name)
    mask = got[2].numpy()
    np.testing.assert_array_equal(mask, np.asarray(want[2]))
    assert mask.any() and not mask.all()


def test_dist_bounds_aabb_matches_jax():
    """Box bounds within 1e-6 (float32 divisions, same order); the outside
    flags bitwise equal, with rays both inside and outside the box."""
    center, ray_unit = _rays(seed=1)
    want = jax_geometry.dist_bounds_aabb(center, ray_unit, AABB)
    got = geometry.dist_bounds_aabb(torch.from_numpy(center), torch.from_numpy(ray_unit), AABB)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and not got[2].all()
