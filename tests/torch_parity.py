"""Shared inputs for the parity tests of the PyTorch port (mlinerf_tpu_torch)
against the JAX package: the TINY config overrides and injected batches.

Inputs are made with numpy from a seed and handed to both packages; ray and
image picks are injected because jax.random draws cannot be reproduced in
torch.
"""

import numpy as np

CONFIG = "configs/syn_sphere_a.yaml"

# Small sizes that keep a CPU step well under a second.
TINY = [
    "--model.render.rand_rays=64", "--model.render.rand_rays_val=512",
    "--model.render.num_samples.coarse=16", "--model.render.num_samples.fine=4",
    "--model.render.num_sample_hierarchy=1", "--model.object.sdf.mlp.hidden_dim=64",
    "--model.object.rgb.mlp.hidden_dim=64", "--model.object.rgb.mlp.num_layers=2",
    "--model.object.sdf.encoding.levels=4",
    "--model.object.sdf.encoding.hashgrid.min_logres=3",
    "--model.object.sdf.encoding.hashgrid.max_logres=6",
    "--model.object.sdf.encoding.hashgrid.dict_size=12",
    "--model.object.sdf.encoding.hashgrid.dim=2",
    "--data.train.image_size=[32,32]", "--data.val.image_size=[32,32]",
    "--data.num_cameras=2", "--data.num_lights=2",
]
# Parity runs: midpoint samples instead of jitter.
DETERMINISTIC = ["--model.render.stratified!"]


def tiny_args(*extra):
    """TINY and DETERMINISTIC with ``extra``: an override in ``extra``
    replaces a TINY one of the same key."""

    def key(arg):
        return arg.split("=")[0].rstrip("!")

    replaced = {key(a) for a in extra}
    return [a for a in TINY + DETERMINISTIC if key(a) not in replaced] + list(extra)


def configs(*extra, config=CONFIG):
    """(JAX package config, port config) from the same YAML and
    ``tiny_args(*extra)``."""
    from mlinerf_tpu.config import Config as JaxConfig
    from mlinerf_tpu_torch.config import Config as TorchConfig

    args = tiny_args(*extra)
    return JaxConfig(config, cli_args=args), TorchConfig(config, cli_args=args)


def jax_stage_a_checkpoint(jcfg, logdir, iteration=3):
    """Save a JAX package stage-a checkpoint of perturbed params (the SDF's
    encoding columns opened a little, random tables) in ``logdir``;
    returns its ``latest_checkpoint.txt`` pointer."""
    import os

    import jax
    import jax.numpy as jnp
    from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer

    jtr = JaxTrainer(jcfg, seed=0, logdir=logdir)
    params = perturb_jax_params(jtr.state.params, np.random.default_rng(0))
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"][3:] *= 0.2
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    jtr.save_checkpoint(iteration=iteration)
    jtr.checkpointer.wait()
    return os.path.join(logdir, "latest_checkpoint.txt")


def port_name(jax_path):
    """The port's state-dict name of a '/'-joined JAX param path."""
    parts = jax_path.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def injected_batch(arrays, rng, num_rays):
    """One image and ``num_rays`` distinct pixels of it, as numpy arrays."""
    N, H, W, _ = arrays["images"].shape
    img_idx = rng.integers(0, N, (1,)).astype(np.int32)
    ray_idx = rng.permutation(H * W)[:num_rays][None].astype(np.int32)
    batch = {"idx": img_idx, "ray_idx": ray_idx}
    for key in ("pose", "intr", "pose_light"):
        batch[key] = arrays[key][img_idx]
    flat = arrays["images"][img_idx].reshape(1, H * W, 3)
    batch["image_sampled"] = np.take_along_axis(flat, ray_idx[..., None].astype(np.int64), axis=1)
    return batch


def perturb_jax_params(params, rng):
    """Give the encoder a say in the output: geometric init zeroes the SDF
    MLP's encoding columns and the tables start at 1e-4, which makes every
    table gradient zero at init. Returns a new tree of numpy arrays."""
    import jax

    tree = jax.tree.map(np.asarray, params)
    sdf = tree["neural_sdf"]
    kernel = np.array(sdf["mlp"]["linear_0"]["kernel"])
    kernel[3:] = rng.normal(0, 0.3, kernel[3:].shape)
    sdf["mlp"]["linear_0"]["kernel"] = kernel.astype(np.float32)
    sdf["hash_table"] = tuple(
        rng.uniform(-0.1, 0.1, t.shape).astype(t.dtype) for t in sdf["hash_table"])
    return tree


def bf16_ulp(a, b):
    """One bf16 ulp of the larger of two torch tensors, per entry (an upper
    bound: eps times the magnitude)."""
    import torch

    return torch.finfo(torch.bfloat16).eps * torch.maximum(a.float().abs(), b.float().abs())


def assert_close_to_leaf_max(got, want, rtol, name=""):
    """|got - want| <= rtol * max|want|, per leaf."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.max(np.abs(want))
    err = np.max(np.abs(got - want)) if want.size else 0.0
    assert err <= rtol * scale, f"{name}: max err {err:.3g} > {rtol} * {scale:.3g}"


# The TINY model on the file-backed datasets, whose configs have no
# procedural-scene keys; each test sets its own image sizes.
TINY_FILES = [a for a in TINY if not a.startswith(("--data.num_", "--data.train.image_size",
                                                   "--data.val.image_size"))]


def pil_save(path, img):
    """Write uint8 [H,W,C] with Pillow (its own row filters)."""
    import os

    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img).save(path)


def dataset_args(root, annotations, size=None):
    """Overrides that point a dataset config at a fixture under ``root``
    (``annotations`` as ``data.fixtures`` returns them), at ``size`` [H, W]."""
    args = [f"--data.root={root}", f"--data.train.annotation={annotations['train']}",
            f"--data.val.annotation={annotations['val']}"]
    if size is not None:
        args += [f"--data.train.image_size=[{size[0]},{size[1]}]", f"--data.val.image_size=[{size[0]},{size[1]}]"]
    return args


def stage_a_loss(losses, out, target):
    """The stage-a loss of the TINY parity runs: L1 x3, eikonal and
    curvature, both masked outside the bounds."""
    return (3 * losses.l1_loss(out["rgb"], target)
            + 0.1 * losses.eikonal_loss(out["gradients"], outside=out["outside"])
            + 5e-4 * losses.curvature_loss(out["hessians"], outside=out["outside"]))


def model_pair(jcfg, tcfg, iteration=10, max_levels=None, jax_cond=None, torch_cond=None, seed=0, amp=False):
    """One training forward and backward of the stage-a loss through the
    JAX package's model and the port's, on the same perturbed params
    (bridged) and the same injected batch, the model of the config's
    ``model.type``. ``jax_cond`` / ``torch_cond`` add entries to each
    side's cond; ``amp``: bf16 MLPs on both sides. Returns the losses,
    outputs, the JAX gradients by port name, the port model (its ``.grad``
    filled) and the JAX params."""
    import jax
    import jax.numpy as jnp
    import torch
    from mlinerf_tpu.config import StaticConfig
    from mlinerf_tpu.config import resolve as jax_resolve
    from mlinerf_tpu.models.neuralangelo import make_cond as jax_make_cond
    from mlinerf_tpu.utils import losses as jax_losses
    from mlinerf_tpu_torch.bridge import params_from_jax
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
    from mlinerf_tpu_torch.models.neuralangelo import make_cond as torch_make_cond
    from mlinerf_tpu_torch.utils import losses as torch_losses

    arrays = TorchDataset(tcfg).as_arrays()
    rng = np.random.default_rng(seed)
    batch = injected_batch(arrays, rng, tcfg.model.render.rand_rays)
    warm = tcfg.optim.sched.warm_up_end
    jmodel = jax_resolve("model", jcfg.model.type)(StaticConfig(jcfg.model), StaticConfig(jcfg.data),
                                                    compute_dtype=jnp.bfloat16 if amp else jnp.float32)
    jcond = jax_make_cond(jcfg.model, jnp.asarray(iteration, jnp.int32), jcfg.max_iter, warm)
    jcond["max_levels"] = max_levels
    jcond.update(jax_cond or {})
    key = jax.random.PRNGKey(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # Jitted (cond's static entries closed over): one compile each instead
    # of eager dispatch, which takes twice as long at this size.
    init = jax.jit(lambda k: jmodel.init(k, jbatch, jcond, k, train=True))
    params = perturb_jax_params(init(key)["params"], rng)

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, jcond, key, train=True)
        return stage_a_loss(jax_losses, out, jbatch["image_sampled"]), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    tmodel = resolve("model", tcfg.model.type)(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0),
                                               compute_dtype=torch.bfloat16 if amp else torch.float32)
    tmodel.load_state_dict(params_from_jax(params))
    tcond = torch_make_cond(tcfg.model, iteration, tcfg.max_iter, warm)
    tcond["max_levels"] = max_levels
    tcond.update(torch_cond or {})
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tout = tmodel(tbatch, tcond, train=True)
    tl = stage_a_loss(torch_losses, tout, tbatch["image_sampled"])
    tl.backward()
    return dict(jl=float(jl), tl=tl.item(), jout={k: np.asarray(v) for k, v in jout.items() if v is not None},
                tout={k: v.detach().numpy() for k, v in tout.items() if v is not None},
                jgrads={k: v.float().numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()},
                tmodel=tmodel, batch=batch, key=key, params=params)


def assert_model_pair_close(pair, grad_rtol=1e-3, loss_rtol=1e-6, out_atol=1e-5):
    """The checks of tests/test_torch_model.py on a ``model_pair``: the
    loss, the rgb, weights and gradients outputs within ``out_atol``, and
    each parameter's gradient within ``grad_rtol`` of that leaf's largest
    entry (a level the encoder skipped has no gradient: zeros)."""
    np.testing.assert_allclose(pair["tl"], pair["jl"], rtol=loss_rtol)
    for key in ("rgb", "weights", "gradients"):
        np.testing.assert_allclose(pair["tout"][key], pair["jout"][key], rtol=0, atol=out_atol, err_msg=key)
    for name, p in pair["tmodel"].named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.float().numpy()
        assert_close_to_leaf_max(got, pair["jgrads"][name], grad_rtol, name)


# ---------------------------------------------------------------------------
# The NeRF family (models/nerf.py, models/ingp.py)
# ---------------------------------------------------------------------------

NERF_TINY = ["--model.mlp.layers_feat=[null,32,32,32]", "--model.mlp.layers_rgb=[null,32,3]", "--model.mlp.skip=[2]",
             "--model.posenc.L_3D=4", "--model.posenc.L_view=2", "--model.rand_rays=32", "--model.rand_rays_val=128",
             "--model.sample_intvs=16", "--model.sample_intvs_fine=16", "--model.sample_stratified!",
             "--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]"]
INGP_TINY = ["--model.mlp.layers_feat=[null,32,32]", "--model.mlp.layers_rgb=[null,32,3]", "--model.posenc.L_view=2",
             "--model.rand_rays=32", "--model.rand_rays_val=128", "--model.sample_intvs=16",
             "--model.sample_stratified!", "--model.posenc.hashgrid.levels=4",
             "--model.posenc.hashgrid.min_logres=2", "--model.posenc.hashgrid.max_logres=6",
             "--model.posenc.hashgrid.dict_size=12", "--model.posenc.hashgrid.range=[-2,2]",
             "--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]"]


def nerf_configs(config, *extra):
    """(JAX package config, port config) of a NeRF-family YAML at the TINY
    size (INGP_TINY for ``model.type: ingp``); an override in ``extra``
    replaces a TINY one of the same key."""
    from mlinerf_tpu.config import Config as JaxConfig
    from mlinerf_tpu_torch.config import Config as TorchConfig

    def key(arg):
        return arg.split("=")[0].rstrip("!")

    replaced = {key(a) for a in extra}
    tiny = INGP_TINY if "ingp" in config else NERF_TINY
    args = [a for a in tiny if key(a) not in replaced] + list(extra)
    return JaxConfig(config, cli_args=args), TorchConfig(config, cli_args=args)


def nerf_batch(cfg, rng):
    """One 16x16 camera and ``model.rand_rays`` of its pixels: on a sphere
    of radius 4 looking at the origin, or, with ``camera_ndc``, looking
    along -z as the LLFF loader's recentred cameras do."""
    from mlinerf_tpu_torch.data.synthetic import look_at_pose

    if cfg.model.camera_ndc:
        pose = np.asarray([[1, 0, 0, 0.05], [0, -1, 0, -0.02], [0, 0, -1, 0.1]], np.float32)
    else:
        pose = look_at_pose(np.asarray([0.5, -3.9, 1.0], np.float32)).astype(np.float32)
    intr = np.asarray([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    R = cfg.model.rand_rays
    return dict(pose=pose[None], intr=intr[None], ray_idx=rng.permutation(256)[:R][None].astype(np.int32),
                image_sampled=rng.uniform(0, 1, (1, R, 3)).astype(np.float32))


def nerf_jax_draws(jcfg, key, batch_shape):
    """The uniforms and normals the JAX package's NeRF ``render_rays`` draws
    from ``key``, as the port's ``draws``."""
    import jax
    import torch

    k_coarse, k_noise, k_noise2 = jax.random.split(key, 3)
    n, nf = jcfg.model.sample_intvs, jcfg.model.sample_intvs_fine
    draws = dict(coarse=jax.random.uniform(k_coarse, (*batch_shape, n, 1)),
                 noise=jax.random.normal(k_noise, (*batch_shape, n)),
                 noise_fine=jax.random.normal(k_noise2, (*batch_shape, n + nf)))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def nerf_pair(config, *extra, amp=False, draws=False, seed=0):
    """One training forward and backward of the NeRF trainer's loss (MSE on
    ``rgb``, and ``rgb_fine`` with fine sampling) through the JAX package's
    model and the port's, on the same params (bridged; hash tables set to
    U(-0.1, 0.1) so their gradients are not negligible) and the same rays.
    ``amp``: bf16 MLPs on both sides. ``draws``: the port gets the JAX
    side's stratified uniforms and density noise. Returns the losses, the
    outputs, the JAX gradients by port name and the port model (its
    ``.grad`` filled)."""
    import jax
    import jax.numpy as jnp
    import torch
    from mlinerf_tpu.config import StaticConfig
    from mlinerf_tpu.config import resolve as jax_resolve
    from mlinerf_tpu_torch.bridge import params_from_jax
    from mlinerf_tpu_torch.config import resolve

    jcfg, tcfg = nerf_configs(config, *extra)
    rng = np.random.default_rng(seed)
    batch = nerf_batch(tcfg, rng)
    jmodel = jax_resolve("model", jcfg.model.type)(StaticConfig(jcfg.model), StaticConfig(jcfg.data),
                                                    compute_dtype=jnp.bfloat16 if amp else jnp.float32)
    key = jax.random.PRNGKey(seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(k, jbatch, None, k, train=True))(key)["params"])
    for field in params.values():
        if "hash_table" in field:
            field["hash_table"] = tuple(rng.uniform(-0.1, 0.1, t.shape).astype(t.dtype) for t in field["hash_table"])

    def loss(out, target, mse):
        total = mse(out["rgb"], target)
        return total + mse(out["rgb_fine"], target) if "rgb_fine" in out else total

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, None, key, train=True)
        return loss(out, jbatch["image_sampled"], lambda a, b: jnp.mean((a - b) ** 2)), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    tmodel = resolve("model", tcfg.model.type)(tcfg.model, tcfg.data, generator=torch.Generator().manual_seed(0),
                                               compute_dtype=torch.bfloat16 if amp else torch.float32)
    tmodel.load_state_dict(params_from_jax(params))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tdraws = nerf_jax_draws(jcfg, key, (1, tcfg.model.rand_rays)) if draws else None
    tout = tmodel(tbatch, train=True, draws=tdraws)
    tl = loss(tout, tbatch["image_sampled"], lambda a, b: torch.mean((a - b) ** 2))
    tl.backward()
    return dict(jl=float(jl), tl=tl.item(), jout={k: np.asarray(v) for k, v in jout.items()},
                tout={k: v.detach().numpy() for k, v in tout.items()},
                jgrads={k: v.float().numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()},
                tmodel=tmodel, params=params, jmodel=jmodel, batch=batch, key=key, jcfg=jcfg, tcfg=tcfg)


def assert_nerf_pair_close(pair, loss_rtol, out_atol, grad_rtol, bias_grad_rtol=None):
    """The loss within ``loss_rtol``, every output within ``out_atol``, each
    parameter's gradient within ``grad_rtol`` of its leaf's largest entry
    (biases within ``bias_grad_rtol`` where given)."""
    np.testing.assert_allclose(pair["tl"], pair["jl"], rtol=loss_rtol)
    assert sorted(pair["tout"]) == sorted(pair["jout"])
    for key, want in pair["jout"].items():
        np.testing.assert_allclose(pair["tout"][key], want, rtol=0, atol=out_atol, err_msg=key)
    for name, p in pair["tmodel"].named_parameters():
        rtol = bias_grad_rtol if bias_grad_rtol is not None and name.endswith(".bias") else grad_rtol
        assert_close_to_leaf_max(p.grad.float().numpy(), pair["jgrads"][name], rtol, name)


# ---------------------------------------------------------------------------
# The JAX package's train step from explicit params
# ---------------------------------------------------------------------------


def halves(batch):
    """The two ranks' slices of a global batch (axis 1 of ``ray_idx`` and
    of the ``*_sampled`` entries)."""
    n = batch["ray_idx"].shape[1] // 2
    return [{k: v[:, r * n:(r + 1) * n] if k == "ray_idx" or k.endswith("_sampled") else v for k, v in batch.items()}
            for r in range(2)]


class JaxSteps:
    """The JAX package's train step (trainers/base.py ``_train_step_fn``)
    from explicit params: the loss and gradient jitted per batch shape (or
    eager, op by op as the port runs), the optax update eager."""

    def __init__(self, jtr, jit=True):
        self.jtr, self.fns, self.jit = jtr, {}, jit

    def grads(self, trainable, frozen, batch, it):
        import jax
        import jax.numpy as jnp
        from mlinerf_tpu.trainers import optim as jax_optim

        jtr = self.jtr
        max_levels = jtr.static_max_levels_for(it)
        key = (max_levels, batch["ray_idx"].shape)
        if key not in self.fns:
            def loss_fn(t, f, b, it):
                cond = dict(jtr.make_cond(it))
                cond["max_levels"] = max_levels
                weights = jtr.loss_weights_at(it, cond)
                params = jax_optim.merge_params(t, f) if f is not None else t
                out = jtr.model.apply({"params": params}, b, cond, jax.random.PRNGKey(0), train=True)
                loss_dict, _ = jtr.compute_loss(out, b, mode="train")
                total = jnp.zeros((), jnp.float32)
                for k, v in loss_dict.items():
                    if k in weights:
                        total = total + weights[k] * v
                return total, loss_dict

            fn = jax.value_and_grad(loss_fn, has_aux=True)
            self.fns[key] = jax.jit(fn) if self.jit else fn
        (total, losses), g = self.fns[key](trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                                           jnp.asarray(it, jnp.int32))
        return g, dict(total=float(total), **{k: float(v) for k, v in losses.items()})

    def run(self, params, batches, split):
        """Steps on ``batches``; ``split`` 2 averages the two halves'
        gradients and losses (DDP). Returns (params, optax state, logged)."""
        import jax
        import jax.numpy as jnp
        from mlinerf_tpu.trainers import optim as jax_optim
        from mlinerf_tpu_torch.bridge import params_from_jax

        jtr = self.jtr
        params = jax.tree.map(jnp.asarray, params)
        if jtr.partial_keywords:
            trainable, frozen = jax_optim.partition_params(params, jtr.partial_keywords)
        else:
            trainable, frozen = params, None
        state = jtr.tx.init(trainable)
        logged = []
        for it, batch in enumerate(batches):
            parts = [self.grads(trainable, frozen, b, it) for b in (halves(batch) if split == 2 else [batch])]
            grads = parts[0][0] if split == 1 else jax.tree.map(lambda a, b: (a + b) / 2, parts[0][0], parts[1][0])
            logged.append({k: float(np.mean([p[1][k] for p in parts])) for k in parts[0][1]})
            updates, state = jtr.tx.update(grads, state, trainable)
            trainable = jax.tree.map(lambda p, u: None if p is None else p + u.astype(p.dtype), trainable, updates,
                                     is_leaf=lambda x: x is None)
        params = jax_optim.merge_params(trainable, frozen) if frozen is not None else trainable
        return params_from_jax(jax.tree.map(np.asarray, params)), state, logged


# ---------------------------------------------------------------------------
# What a CUDA-graph capture refuses, found on the CPU
# ---------------------------------------------------------------------------

# Ops that read a tensor's value on the host (a data-dependent shape counts)
# or make a tensor of host data (``lift_fresh``: torch.tensor, an index list).
HOST_READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select", "aten::_unique2",
              "aten::unique_dim", "aten::unique_consecutive", "aten::lift_fresh"}


def watch_host_reads(trainer):
    """Wrap ``trainer._window_step`` (the body a CUDA graph captures) so that
    each call records every op of ``HOST_READS`` it runs, as (op, the port's
    file:line), and every call of torch.tensor, as_tensor or from_numpy.
    Returns the two lists (reads, made), which fill as the steps run. On a
    card either would wait for the device or copy into the program, which a
    capture refuses (``torch.cuda.set_sync_debug_mode("error")`` is on
    during each capture)."""
    import functools
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    reads, made = [], []

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name in HOST_READS:
                frames = [f for f in traceback.extract_stack() if "mlinerf_tpu_torch" in f.filename]
                reads.append((func._schema.name, f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"))
            return func(*args, **(kwargs or {}))

    inner = trainer._window_step

    def watched(*args, **kwargs):
        originals = {name: getattr(torch, name) for name in ("tensor", "as_tensor", "from_numpy")}
        for name, fn in originals.items():
            setattr(torch, name, functools.partial(lambda fn, name, *a, **k: (made.append(name), fn(*a, **k))[1],
                                                   fn, name))
        try:
            with HostReads():
                return inner(*args, **kwargs)
        finally:
            for name, fn in originals.items():
                setattr(torch, name, fn)

    trainer._window_step = watched
    return reads, made
