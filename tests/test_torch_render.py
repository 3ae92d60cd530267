"""The port's light-visibility render (Lumen ``render_chunk`` with
``with_light_visibility=True``) against the JAX package's, on the same
bridged params and the same full-image rays, for every camera-ray type and
both visibility estimators, and with box visibility or scene bounds.

Sphere tracing latches its mask on ``<=``/``>=`` comparisons, so a float32
difference in an SDF can flip a grazing ray: the boolean outputs are held by
their share of mismatched rays (at most 1%), the continuous ones by an
absolute tolerance on the rays whose booleans agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, injected_batch, perturb_jax_params

from mlinerf_tpu.config import StaticConfig
from mlinerf_tpu.models.lumen import Model as JaxModel
from mlinerf_tpu.models.neuralangelo import make_cond as jax_make_cond
from mlinerf_tpu.utils import camera as jax_camera
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.models.lumen import Model as TorchModel
from mlinerf_tpu_torch.models.neuralangelo import make_cond as torch_make_cond

ITER = 10
SIZE = (24, 24)
CONTINUOUS = ("rgb", "opacity", "depth", "gradient", "normal_x_light", "pseudo_shading", "inter_dist")
BOOLEAN = ("visibility", "inter_mask")
AABB = [-0.7, -0.6, -0.5, 0.6, 0.7, 0.4]
# (camera_ray_type, visibility type, visibility bounds, scene bounds)
CASES = [
    ("blend_z_sphere_tracing", "sphere_tracing", "sphere", "unit_sphere"),
    ("blend_z", "sphere_tracing", "sphere", "unit_sphere"),
    ("sphere_tracing", "sphere_tracing", "sphere", "unit_sphere"),
    ("blend_z_sphere_tracing", "render_light_visibility", "sphere", "unit_sphere"),
    ("blend_z", "render_light_visibility", "sphere", "unit_sphere"),
    ("sphere_tracing", "render_light_visibility", "sphere", "unit_sphere"),
    ("blend_z_sphere_tracing", "sphere_tracing", "box", "unit_sphere"),
    ("blend_z_sphere_tracing", "sphere_tracing", "sphere", "box"),
]


@pytest.fixture(scope="module")
def shared():
    """Perturbed JAX params (the SDF then has surfaces the traces find) and
    one full image's rays and light."""
    jcfg, tcfg = configs("--model.object.sdf.encoding.hashgrid.dtype=float32")
    arrays = TorchDataset(tcfg).as_arrays()
    rng = np.random.default_rng(0)
    batch = injected_batch(arrays, rng, tcfg.model.render.rand_rays)
    jmodel = JaxModel(StaticConfig(jcfg.model), StaticConfig(jcfg.data))
    jcond = jax_make_cond(jcfg.model, jnp.asarray(ITER, jnp.int32), jcfg.max_iter, jcfg.optim.sched.warm_up_end)
    key = jax.random.PRNGKey(0)
    params = jmodel.init(key, {k: jnp.asarray(v) for k, v in batch.items()}, jcond, key, train=True)["params"]
    params = perturb_jax_params(params, rng)
    # A fifth of that perturbation keeps the SDF positive where the rays
    # enter the bounding sphere, so the traces converge on about 60% of the
    # rays instead of none.
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"][3:] *= 0.2
    center, ray = jax_camera.get_center_and_ray(jnp.asarray(arrays["pose"][:1]), jnp.asarray(arrays["intr"][:1]),
                                                SIZE)
    light = jax_camera.get_camera_center(jnp.asarray(arrays["pose_light"][1:2]), num_pixels=1)
    pts_light = jnp.broadcast_to(light, ray.shape)
    return dict(params=params, rays=[np.asarray(x) for x in (center, ray, pts_light)])


def _render_both(shared, camera_ray_type, vis_type, bounding, scene_bounds):
    extra = [f"--model.light_visibility.camera_ray_type={camera_ray_type}",
             f"--model.light_visibility.type={vis_type}",
             f"--model.light_visibility.visibility_bounding_type={bounding}",
             "--model.object.sdf.encoding.hashgrid.dtype=float32"]
    jcfg, tcfg = configs(*extra)
    for cfg in (jcfg, tcfg):  # no config file of the synthetic scene names these keys
        cfg.model.light_visibility.visibility_bounding_box_aabb = AABB
        cfg.data.bounding_type = scene_bounds
        cfg.data.bounding_box_aabb = AABB
    center, ray, pts_light = shared["rays"]
    jmodel = JaxModel(StaticConfig(jcfg.model), StaticConfig(jcfg.data))
    jcond = jax_make_cond(jcfg.model, jnp.asarray(ITER, jnp.int32), jcfg.max_iter, jcfg.optim.sched.warm_up_end)
    jout = jmodel.apply({"params": jax.tree.map(jnp.asarray, shared["params"])}, jnp.asarray(center),
                        jnp.asarray(ray), jcond, pts_light=jnp.asarray(pts_light), rng=jax.random.PRNGKey(0),
                        with_light_visibility=True, method=jmodel.render_chunk)
    tmodel = TorchModel(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(params_from_jax(shared["params"]))
    tcond = torch_make_cond(tcfg.model, ITER, tcfg.max_iter, tcfg.optim.sched.warm_up_end)
    t = torch.from_numpy
    with torch.no_grad():
        tout = tmodel.render_chunk(t(center), t(ray), tcond, pts_light=t(pts_light), with_light_visibility=True)
    return ({k: np.asarray(jout[k]) for k in CONTINUOUS + BOOLEAN},
            {k: tout[k].numpy() for k in CONTINUOUS + BOOLEAN})


@pytest.mark.parametrize("camera_ray_type,vis_type,bounding,scene_bounds", CASES)
def test_light_visibility_render_matches_jax(shared, camera_ray_type, vis_type, bounding, scene_bounds):
    """Booleans: at most 1% of the rays differ (measured: 0 of 576 in every
    case). Continuous outputs on the rays whose booleans agree: within 1e-4
    (measured: at most 1.5e-5, in ``normal_x_light``, where the composited
    tap-difference gradient is normalized; 3.8e-6 in ``inter_dist`` after
    the 20 dependent trace steps)."""
    want, got = _render_both(shared, camera_ray_type, vis_type, bounding, scene_bounds)
    rays = want["rgb"].shape[1]
    agree = np.ones(want["rgb"].shape[:2], bool)
    for key in BOOLEAN:
        assert got[key].dtype == np.bool_ and got[key].shape == want[key].shape
        differ = got[key][..., 0] != want[key][..., 0]
        assert differ.sum() <= 0.01 * rays, f"{key}: {differ.sum()} of {rays} rays differ"
        agree &= ~differ
    # The render must reach both outcomes, or the comparison proves little.
    assert want["visibility"].any() and not want["visibility"].all()
    assert want["inter_mask"].any()
    for key in CONTINUOUS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key][agree], want[key][agree], rtol=0, atol=1e-4, err_msg=key)
