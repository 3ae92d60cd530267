"""The Neuralangelo family's own branches in the port against the JAX
package at the TINY size: the background NeRF (plain and light-conditioned),
the ``NeuralRGB`` head (every input mode, Fourier view encoding), the
``neuralangelo`` model's render with the background and appearance
embeddings, and the Lumen model with the background; then both through the
port's CLIs on the CPU.

Tolerances: float32 outputs within 1e-5; each parameter's gradient within
1e-4 of its leaf's largest entry (the sums over rays and samples run in
another order)."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, assert_close_to_leaf_max, configs, model_pair

from mlinerf_tpu.config import StaticConfig
from mlinerf_tpu.models import fields as jax_fields
from mlinerf_tpu.models.mlp import MLPwithSkipConnection as JaxMLP
from mlinerf_tpu.models.neuralangelo import Model as JaxAngelo
from mlinerf_tpu.utils import encoding as jax_encoding
from mlinerf_tpu_torch import test as test_cli
from mlinerf_tpu_torch import train as train_cli
from mlinerf_tpu_torch.bridge import params_from_jax, params_from_jax_checkpoint
from mlinerf_tpu_torch.models import fields
from mlinerf_tpu_torch.models.lumen import Model as TorchLumen
from mlinerf_tpu_torch.models.neuralangelo import Model as TorchAngelo
from mlinerf_tpu_torch.utils.image_io import read_png

F32 = "--model.object.sdf.encoding.hashgrid.dtype=float32"
# The background at a small width: 4 layers (skip at 2), L4 / SH 3, 8 samples.
BACKGROUND = ["--model.background.enabled=True", "--model.background.mlp.hidden_dim=32",
              "--model.background.mlp.hidden_dim_rgb=16", "--model.background.mlp.num_layers=4",
              "--model.background.mlp.skip=[2]", "--model.background.encoding.levels=4",
              "--model.render.num_samples.background=8"]
# 2 cameras x 2 lights of the procedural scene.
EMBEDDINGS = ["--model.appear_embed.enabled=True", "--model.appear_embed.dim=4", "--data.num_images=4"]
ANGELO = ["--model.type=neuralangelo", "--trainer.type=neuralangelo", "--model.background.white=False"]
OUT_TOL = 1e-5
GRAD_RTOL = 1e-4


def _inputs(shape, rng):
    """Points off the unit sphere, unit view rays and light positions."""
    pts = rng.normal(size=shape + (3,)) * 2.0
    rays = rng.normal(size=shape + (3,))
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    light = rng.normal(size=shape + (3,)) * 3.0
    return [a.astype(np.float32) for a in (pts, rays, light)]


# ---------------------------------------------------------------------------
# The fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_light,app", [(False, False), (True, False), (False, True), (True, True)])
def test_background_nerf_matches_jax(with_light, app):
    """rgb and density of the inverse-sphere background NeRF (the Lumen
    model's with the light position's encoding), with and without the
    appearance input, within 1e-5."""
    _, tcfg = configs(*BACKGROUND, *EMBEDDINGS)
    cfg_bg, cfg_app = tcfg.model.background, tcfg.model.appear_embed
    cfg_app.enabled = app
    rng = np.random.default_rng(1)
    pts, rays, light = _inputs((2, 5, 8), rng)
    app_outside = rng.normal(size=(2, 5, 8, 4)).astype(np.float32) if app else None
    jnet = jax_fields.BackgroundNeRF(StaticConfig(cfg_bg), appear_embed=StaticConfig(cfg_app), with_light=with_light)
    jargs = [jnp.asarray(pts), jnp.asarray(rays), jnp.asarray(light) if with_light else None,
             None if app_outside is None else jnp.asarray(app_outside)]
    params = jnet.init(jax.random.PRNGKey(0), *jargs)["params"]
    want_rgb, want_density = jnet.apply({"params": params}, *jargs)
    net = fields.BackgroundNeRF(cfg_bg, appear_embed=cfg_app, generator=torch.Generator().manual_seed(0),
                                with_light=with_light)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    targs = [torch.from_numpy(pts), torch.from_numpy(rays), torch.from_numpy(light) if with_light else None,
             None if app_outside is None else torch.from_numpy(app_outside)]
    rgb, density = net(*targs)
    assert rgb.shape == (2, 5, 8, 3) and density.shape == (2, 5, 8)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(want_rgb), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(density.detach().numpy(), np.asarray(want_density), rtol=0, atol=OUT_TOL)


def _rgb_inputs(feat_dim, rng):
    p, v, _ = _inputs((1, 40), rng)
    n = rng.normal(size=(1, 40, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    f = rng.normal(size=(1, 40, feat_dim)).astype(np.float32)
    app = rng.normal(size=(1, 40, 4)).astype(np.float32)
    return p, n, v, f, app


@pytest.mark.parametrize("view", ["spherical", "fourier"])
def test_neural_rgb_idr_matches_jax(view):
    """The idr head with the appearance input, on SH (levels 3) and
    Fourier (levels 2) view encodings, within 1e-5."""
    _, tcfg = configs(*EMBEDDINGS, f"--model.object.rgb.encoding_view.type={view}",
                      f"--model.object.rgb.encoding_view.levels={3 if view == 'spherical' else 2}")
    feat_dim = tcfg.model.object.sdf.mlp.hidden_dim
    p, n, v, f, app = _rgb_inputs(feat_dim, np.random.default_rng(2))
    jhead = jax_fields.NeuralRGB(StaticConfig(tcfg.model.object.rgb), feat_dim=feat_dim,
                                 appear_embed=StaticConfig(tcfg.model.appear_embed))
    params = jhead.init(jax.random.PRNGKey(1), p, n, v, f, app=app)["params"]
    want = np.asarray(jhead.apply({"params": params}, p, n, v, f, app=app))
    head = fields.NeuralRGB(tcfg.model.object.rgb, feat_dim=feat_dim, appear_embed=tcfg.model.appear_embed,
                            generator=torch.Generator().manual_seed(0))
    head.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    got = head(*map(torch.from_numpy, (p, n, v, f)), app=torch.from_numpy(app))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("input_mode,kept", [("no_view_dir", "pnf"), ("no_normal", "pvf")])
def test_neural_rgb_input_variants(input_mode, kept):
    """Without the view direction or the normal: the JAX package's
    ``NeuralRGB`` raises in these modes (``list.remove`` compares arrays),
    so the port is held to its intended function, the JAX MLP on [p, n, f]
    or [p, v, f] and the appearance input, within 1e-5."""
    _, tcfg = configs(*EMBEDDINGS, f"--model.object.rgb.mode={input_mode}")
    cfg_rgb = tcfg.model.object.rgb
    feat_dim = tcfg.model.object.sdf.mlp.hidden_dim
    p, n, v, f, app = _rgb_inputs(feat_dim, np.random.default_rng(3))
    jhead = jax_fields.NeuralRGB(StaticConfig(cfg_rgb), feat_dim=feat_dim,
                                 appear_embed=StaticConfig(tcfg.model.appear_embed))
    with pytest.raises((ValueError, TypeError)):
        jhead.init(jax.random.PRNGKey(1), p, n, v, f, app=app)
    parts = dict(p=p, v=jax_encoding.spherical_harmonics(jnp.asarray(v), cfg_rgb.encoding_view.levels), n=n, f=f)
    x = jnp.concatenate([jnp.asarray(parts[k]) for k in kept] + [jnp.asarray(app)], -1)
    jmlp = JaxMLP(layer_dims=tuple([x.shape[-1]] + [cfg_rgb.mlp.hidden_dim] * cfg_rgb.mlp.num_layers + [3]),
                  skip_connection=tuple(cfg_rgb.mlp.skip), activ=jax.nn.relu, use_weightnorm=cfg_rgb.mlp.weight_norm)
    params = jmlp.init(jax.random.PRNGKey(1), x)["params"]
    want = np.asarray(jax.nn.sigmoid(jmlp.apply({"params": params}, x)))
    head = fields.NeuralRGB(cfg_rgb, feat_dim=feat_dim, appear_embed=tcfg.model.appear_embed,
                            generator=torch.Generator().manual_seed(0))
    head.load_state_dict(params_from_jax({"mlp": jax.tree.map(np.asarray, params)}))
    got = head(*map(torch.from_numpy, (p, n, v, f)), app=torch.from_numpy(app))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=OUT_TOL)


# ---------------------------------------------------------------------------
# The models' renders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def angelo():
    """One training forward and backward of the stage-a loss through the
    ``neuralangelo`` model with the background and embeddings on."""
    return model_pair(*configs(F32, *ANGELO, *BACKGROUND, *EMBEDDINGS), iteration=10, max_levels=4)


@pytest.fixture(scope="module")
def lumen_bg():
    """The same through the Lumen model (plain rgb head, white background)
    with the light-conditioned background and embeddings on."""
    return model_pair(*configs(F32, *BACKGROUND, *EMBEDDINGS), iteration=10, max_levels=4)


@pytest.mark.parametrize("pair", ["angelo", "lumen_bg"])
def test_param_names_keep_jax_leaves(pair, request):
    """The port's state dict has the JAX tree's leaves by name and shape:
    ``background_nerf.mlp_feat`` / ``mlp_rgb``, ``appear_embed.weight`` and
    ``appear_embed_outside.weight`` (the flax ``embedding``, untransposed);
    a JAX checkpoint's payload goes through ``params_from_jax_checkpoint``."""
    p = request.getfixturevalue(pair)
    got = {k: tuple(v.shape) for k, v in p["tmodel"].state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in p["jgrads"].items()}
    assert {"appear_embed.weight", "appear_embed_outside.weight", "background_nerf.mlp_feat.linear_0.weight",
            "background_nerf.mlp_rgb.linear_0.weight"} <= set(got)
    state = params_from_jax_checkpoint({"state": {"params": p["params"]}})
    np.testing.assert_array_equal(state["appear_embed.weight"].numpy(), p["params"]["appear_embed"]["embedding"])
    p["tmodel"].load_state_dict(state)


@pytest.mark.parametrize("pair", ["angelo", "lumen_bg"])
@pytest.mark.parametrize("key", ["rgb", "weights", "dists", "gradients", "outside"])
def test_render_outputs_match(pair, key, request):
    """Object and background samples composited together: the samples
    axis carries both (rgb, weights, dists), within 1e-5. The background's
    distances, far / u up to 16 x far, are held to 1e-6 of their value
    instead: the far bound's rounding is scaled by 1 / u (measured: 6.3e-7
    relative, 2.7e-5 absolute at 45)."""
    p = request.getfixturevalue(pair)
    got, want = p["tout"][key], p["jout"][key]
    assert got.shape == want.shape
    if key == "dists":
        n_obj = got.shape[-2] - 8
        np.testing.assert_allclose(got[..., n_obj:, :], want[..., n_obj:, :], rtol=1e-6, atol=0)
        got, want = got[..., :n_obj, :], want[..., :n_obj, :]
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("pair", ["angelo", "lumen_bg"])
def test_loss_and_param_grads_match(pair, request):
    """The loss within 1e-6 (relative); every parameter's gradient (the
    background's and the embeddings' included) within 1e-4 of its leaf's
    largest entry; the embeddings of the batch's image get a gradient."""
    p = request.getfixturevalue(pair)
    np.testing.assert_allclose(p["tl"], p["jl"], rtol=1e-6)
    assert p["tout"]["dists"].shape[-2] == 16 + 4 + 8
    for name, param in p["tmodel"].named_parameters():
        assert_close_to_leaf_max(param.grad.numpy(), p["jgrads"][name], GRAD_RTOL, name)
    idx = int(p["batch"]["idx"][0])
    for table in ("appear_embed", "appear_embed_outside"):
        grad = getattr(p["tmodel"], table).weight.grad
        assert grad[idx].abs().max() > 0 and grad[np.arange(4) != idx].abs().max() == 0, table


def test_background_dists_match_jax_stratified():
    """Stratified background distances from the same uniforms: JAX's draw
    handed to the port (``rands``), within 1e-6 relative."""
    jcfg, tcfg = configs(*BACKGROUND)
    rng = np.random.default_rng(4)
    _, rays, _ = _inputs((1, 6), rng)
    far = rng.uniform(1.5, 3.0, (1, 6, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmodel = JaxAngelo(StaticConfig(jcfg.model), StaticConfig(jcfg.data))
    want, _ = jmodel.init_with_output(jax.random.PRNGKey(0), jnp.asarray(rays), jnp.asarray(far), True, key,
                                      method=lambda m, *a: m.sample_dists_background(*a))
    rands = jax.random.uniform(key, (1, 6, 8, 1))
    model = TorchAngelo(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))
    got = model.sample_dists_background(torch.from_numpy(rays), torch.from_numpy(far), True,
                                        rands=torch.from_numpy(np.array(rands)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.all(np.diff(got.numpy()[..., 0], axis=-1) > 0) and np.all(got.numpy() > far[..., None])


def test_background_with_intrinsic_mode_raises():
    """The background goes with the plain rgb head only, as in the JAX
    package."""
    _, tcfg = configs(*BACKGROUND, "--model.object.rgb.network_mode=rgb_r_s", config="configs/syn_sphere_b.yaml")
    with pytest.raises(NotImplementedError, match="network_mode"):
        TorchLumen(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))


def test_embeddings_need_num_images():
    _, tcfg = configs(*ANGELO, "--model.appear_embed.enabled=True")
    with pytest.raises(ValueError, match="data.num_images"):
        TorchAngelo(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def test_angelo_train_and_render_cli(tmp_path):
    """``python -m mlinerf_tpu_torch.train`` trains the ``neuralangelo``
    model with the background and embeddings through the registry, and
    ``test --inference_mode image_test`` renders it (the zero embedding:
    a full image has no training-image index)."""
    logdir = str(tmp_path / "angelo")
    args = ["--config", "configs/syn_sphere_a.yaml", "--logdir", logdir, "--device", "cpu",
            *[a for a in TINY if "image_size" not in a], *ANGELO, *BACKGROUND, *EMBEDDINGS,
            "--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]"]
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main(args + ["--max_iter=2", "--logging_iter=1"])
        assert type(trainer.model) is TorchAngelo and trainer.model.with_background
        test_cli.main(args + ["--inference_mode", "image_test", "--data.val.subset=1"])
    rgb = read_png(f"{logdir}/output_image/0_rgb_map.png")
    assert rgb.shape == (16, 16, 3) and rgb.std() > 0
