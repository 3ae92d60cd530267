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


def configs(*extra, config=CONFIG):
    """(JAX package config, port config) from the same YAML and overrides;
    an override in ``extra`` replaces a TINY one of the same key."""
    from mlinerf_tpu.config import Config as JaxConfig
    from mlinerf_tpu_torch.config import Config as TorchConfig

    def key(arg):
        return arg.split("=")[0].rstrip("!")

    replaced = {key(a) for a in extra}
    args = [a for a in TINY + DETERMINISTIC if key(a) not in replaced] + list(extra)
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
