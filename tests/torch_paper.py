"""Shared inputs of the parity tests of the paper's stage b on its
MLI-synthetic and NRHints layouts (configs/syn_hotdog_{a,b}.yaml,
configs/NRHints_Pikachu_{a,b}.yaml, the ``lumen_blender`` loader): the
fixtures, both packages' configs, one JAX stage-a checkpoint and the
``unpair`` renders and labels of it.

Both b configs have one model (NRHints_Pikachu_a inherits syn_hotdog_a and
changes only ``data``), so one JAX checkpoint and one JAX trainer per stage
serve both layouts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import DETERMINISTIC, TINY_FILES, dataset_args, perturb_jax_params, pil_save

SIZE = (12, 12)
LAYOUTS = {"mli": "configs/syn_hotdog_{}.yaml", "nrhints": "configs/NRHints_Pikachu_{}.yaml"}
# lr(0) > 0, so that one step moves the heads.
SMALL = [f"--data.train.image_size=[{SIZE[0]},{SIZE[1]}]", f"--data.val.image_size=[{SIZE[0]},{SIZE[1]}]",
         "--optim.sched.warm_up_end=0"]


def write_scenes(root):
    """A fixture of 4 train and 3 validation frames in each layout (24x24
    files, read at SIZE); returns each layout's overrides (TINY, midpoint
    samples, the fixture)."""
    from mlinerf_tpu_torch.data import fixtures

    out = {}
    for layout in LAYOUTS:
        annotations = fixtures.write_point_light(str(root / layout), image_size=24, train=4, val=3, lights=2,
                                                 source="nrhints" if layout == "nrhints" else "mli", seed=3,
                                                 save=pil_save)
        out[layout] = TINY_FILES + DETERMINISTIC + SMALL + dataset_args(str(root / layout), annotations)
    return out


def layout_configs(scenes, layout, stage, *extra):
    """(JAX package config, port config) of ``layout``'s stage ``stage``."""
    from mlinerf_tpu.config import Config as JaxConfig
    from mlinerf_tpu_torch.config import Config

    path = LAYOUTS[layout].format(stage)
    args = scenes[layout] + list(extra)
    return JaxConfig(path, cli_args=args), Config(path, cli_args=args)


def datasets(scenes, layout, stage, *extra, is_inference=False):
    """Both packages' ``lumen_blender`` datasets of ``layout``."""
    from mlinerf_tpu.config import resolve as jax_resolve
    from mlinerf_tpu_torch.config import resolve

    jcfg, tcfg = layout_configs(scenes, layout, stage, *extra)
    return (jax_resolve("dataset", "lumen_blender")(jcfg, is_inference=is_inference),
            resolve("dataset", "lumen_blender")(tcfg, is_inference=is_inference))


def jax_stage_a(scenes, logdir):
    """A JAX inference trainer of syn_hotdog_a whose params are perturbed
    (the SDF's encoding columns opened a little, random tables) and saved
    as a checkpoint of iteration 3 in ``logdir``; returns (trainer, its
    ``latest_checkpoint.txt``)."""
    from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer

    jcfg, _ = layout_configs(scenes, "mli", "a")
    jtr = JaxTrainer(jcfg, is_inference=True, seed=0, logdir=logdir)
    params = perturb_jax_params(jtr.state.params, np.random.default_rng(0))
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"][3:] *= 0.2
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    jtr.save_checkpoint(iteration=3)
    jtr.checkpointer.wait()
    pointer = os.path.join(logdir, "latest_checkpoint.txt")
    assert jtr.load_checkpoint(pointer, resume=False, load_opt=False)
    return jtr, pointer


def port_inference_trainer(scenes, layout, pointer, logdir):
    from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

    _, tcfg = layout_configs(scenes, layout, "a")
    ttr = TorchTrainer(tcfg, is_inference=True, seed=0, logdir=logdir, device="cpu")
    assert ttr.load_checkpoint(pointer) and ttr.current_iteration == 3
    return ttr


def jax_unpair(jtr, dataset, output_dir):
    """JAX's ``unpairlights_train`` renders of ``dataset`` and its
    ``unpair`` labels of them, saved as ``<output_dir>/pseudo_label_all.npz``;
    returns (results_all, labels, the labels' file)."""
    from mlinerf_tpu.pipelines import pseudo_label as jax_pl
    from mlinerf_tpu.pipelines.label_store import save_results_all

    results = jtr.test_all_light(dataset, output_dir, dataset_type="unpair", sample_num=4, seed=999,
                                 save_pngs=False)
    labels = jax_pl.generate_pseudo_labels(results, "unpair")
    save_results_all(labels, os.path.join(output_dir, "pseudo_label_all"))
    return results, labels, os.path.join(output_dir, "pseudo_label_all.npz")


def jax_first_index(num_sets, num_points):
    """The first k-means centre of each pixel as the JAX package draws it
    (``kmeans_per_pixel`` splits PRNGKey(0) into one key per set)."""
    keys = jax.random.split(jax.random.PRNGKey(0), num_sets)
    draws = jax.vmap(lambda k: jax.random.randint(k, (), 0, num_points))(keys)
    return torch.from_numpy(np.asarray(draws).astype(np.int64))
