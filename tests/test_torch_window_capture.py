"""The body that a CUDA graph captures for each training path the port
captures on a card (``BaseTrainer._window_step``: Lumen stage a on the
exact and the fast path and its opt-in knobs, the neuralangelo model with
the background and embeddings, analytical gradients, bf16 MLPs, EMA, NeRF
and Instant-NGP), run on the CPU at a small size: it must neither read a
tensor's value on the host nor build a tensor from host data. On a card
either would wait for the device or copy into the program, which a capture
refuses (``torch.cuda.set_sync_debug_mode("error")`` is on during each
capture); this finds them before the card does."""

import numpy as np
import pytest
import torch

from torch_parity import INGP_TINY, NERF_TINY, tiny_args, watch_host_reads

from mlinerf_tpu_torch.config import Config as TorchConfig
from mlinerf_tpu_torch.config import resolve

_BACKGROUND = ["--model.background.enabled=True", "--model.background.mlp.hidden_dim=32",
               "--model.background.mlp.hidden_dim_rgb=16", "--model.background.mlp.num_layers=4",
               "--model.background.mlp.skip=[2]", "--model.background.encoding.levels=4",
               "--model.render.num_samples.background=8"]
CAPTURED_PATHS = {
    "stage_a": ("configs/syn_sphere_a.yaml", []),
    "e2e": ("configs/syn_e2e_a.yaml", []),
    "analytical": ("configs/syn_sphere_a.yaml", ["--model.object.sdf.gradient.mode=analytical"]),
    "neuralangelo": ("configs/syn_sphere_a.yaml", ["--model.type=neuralangelo", "--trainer.type=neuralangelo",
                                                   "--model.appear_embed.enabled=True", "--model.appear_embed.dim=4",
                                                   "--data.num_images=4", *_BACKGROUND]),
    "bf16_mlps": ("configs/syn_sphere_a.yaml", ["--trainer.amp_config.enabled"]),
    "occupancy": ("configs/syn_e2e_a.yaml", ["--model.render.occupancy.enabled",
                                             "--model.render.occupancy.resolution=8"]),
    "corner_sample": ("configs/syn_e2e_a.yaml", ["--model.object.sdf.gradient.corner_sample.enabled",
                                                 "--model.object.sdf.gradient.corner_sample.mode=top1cot"]),
    "subsample": ("configs/syn_e2e_a.yaml", ["--model.object.sdf.gradient.subsample.enabled"]),
    "ema": ("configs/syn_sphere_ema_a.yaml", []),
    "nerf": ("configs/nerf_synthetic_low.yaml", [*NERF_TINY, "--data.num_cameras=2"]),
    "ingp": ("configs/ingp_blender.yaml", [*INGP_TINY, "--data.type=synthetic"]),
}


@pytest.mark.parametrize("path", sorted(CAPTURED_PATHS))
def test_window_step_reads_nothing_on_the_host(path, tmp_path):
    """The body that a CUDA graph captures (``_window_step``, after a warm-up
    step) makes no host read of a tensor (item, float, bool, a
    data-dependent shape) and builds no tensor from host data
    (torch.tensor, as_tensor, from_numpy, an index list): either would wait for the card
    or copy into the program, which a capture refuses."""
    config, extra = CAPTURED_PATHS[path]
    cli = extra if "nerf" in config or "ingp" in config else [*_tiny_without_images(), *extra]
    tcfg = TorchConfig(config, cli_args=cli)
    ttr = resolve("trainer", tcfg.trainer.type)(tcfg, seed=0, logdir=str(tmp_path), device="cpu")
    arrays = {k: torch.as_tensor(np.asarray(v)) for k, v in
              resolve("dataset", tcfg.data.type)(tcfg).as_arrays().items()}
    ttr.maybe_update_occupancy()
    ttr.run_window(arrays, 1)  # the warm-up: caches fill here
    reads, made = watch_host_reads(ttr)
    ttr.run_window(arrays, 1)
    assert reads == [], reads
    assert made == [], made


def _tiny_without_images():
    return [a for a in tiny_args() if not a.startswith("--data.")] + [
        "--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]", "--data.num_cameras=2",
        "--data.num_lights=2"]
