"""One stage-b step of configs/syn_hotdog_b.yaml and
configs/NRHints_Pikachu_b.yaml (tests/torch_paper.py's layouts) in the
port against the JAX package at the TINY size: both trainers warm-started
from one JAX stage-a checkpoint (the port then takes the JAX trainer's
params, so the new ``rgb_r_s`` heads start equal), one batch per layout
(numpy picks gathered by the port, JAX's ``unpair`` labels per ray)
through both packages' loss and gradient, then the port's train step:

- the render, intrinsic and regularize_re losses at the configs' weights;
- the gradients of the radiance heads, the only trainable leaves
  (``partial_training``/``partial_grad``: neural_rgb);
- the SDF and its hash tables bitwise unchanged, no table-gradient scatter.

Bounds: losses within 1e-5 relative (measured at most 1.3e-6, MLI's
render loss), the frozen SDF's eikonal and curvature terms within the
bounds of tests/test_torch_stage_b_lockstep.py, 5e-5 and 5e-4 (measured
6.0e-6 and 1.8e-4: the curvature's finite differences round differently);
each head leaf's gradient within 1e-4 of the leaf's largest entry
(measured at most 4.2e-6 against the jitted JAX step, every row, also
that of a unit of NRHints' ``mlp_r.linear_0`` whose pre-activation comes
within 1.3e-8 of a ReLU's edge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_paper import LAYOUTS, SIZE, datasets, jax_stage_a, jax_unpair, layout_configs, write_scenes
from torch_parity import JaxSteps

from mlinerf_tpu.trainers import optim as jax_optim
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.ops import hashgrid_scatter
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

LOSS_RTOL = 1e-5
SDF_RTOL = {"eikonal": 5e-5, "curvature": 5e-4}
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def stage_b(tmp_path_factory):
    """Per layout: JAX's labels of JAX's renders, the port's stage-b trainer
    and dataset on them; one JAX stage-b trainer (syn_hotdog_b) whose params
    the port's trainers take."""
    scenes = write_scenes(tmp_path_factory.mktemp("paper"))
    jtr_a, pointer = jax_stage_a(scenes, str(tmp_path_factory.mktemp("jax_a")))
    warm = f"--model.use_pre_trained.pt_filename={pointer}"
    out = {}
    for layout in LAYOUTS:
        jds, _ = datasets(scenes, layout, "a")
        _, labels, label_file = jax_unpair(jtr_a, jds, str(tmp_path_factory.mktemp(f"renders_{layout}")))
        jcfg, tcfg = layout_configs(scenes, layout, "b", warm, f"--data.train.pseudo_label.pt_file={label_file}")
        if "jtr" not in out:
            out["jtr"] = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax_b")))
        ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("port_b")), device="cpu")
        assert any(".mlp_r." in n for n in ttr.warm_start_report["missing"])
        ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, out["jtr"].state.params)))
        _, tds = datasets(scenes, layout, "b", f"--data.train.pseudo_label.pt_file={label_file}")
        out[layout] = dict(ttr=ttr, arrays=tds.as_arrays())
    return out


def _port_loss_grads(trainer, batch):
    """The train step's losses and the trainable leaves' gradients on
    ``batch`` (no update)."""
    it = trainer.current_iteration
    cond = trainer.make_cond(it)
    cond["max_levels"] = trainer.static_max_levels_for(it)
    weights = trainer.loss_weights_at(it, cond)
    output = trainer.model(batch, cond, generator=trainer.render_generator, train=True)
    losses, _ = trainer.compute_loss(output, batch, mode="train")
    total = sum(weights[k] * v for k, v in losses.items() if k in weights)
    grads = torch.autograd.grad(total, trainer.trainable_params, allow_unused=True)
    return ({"total": total.item(), **{k: v.item() for k, v in losses.items()}},
            {n: (torch.zeros_like(p) if g is None else g) for n, p, g in
             zip(trainer.trainable_names, trainer.trainable_params, grads)})


@pytest.fixture(scope="module")
def one_step(stage_b):
    """Per layout one batch of numpy picks (the port's gather: the pixels
    and their labels) through the JAX package's loss and gradient and the
    port's, then the port's train step."""
    jtr = stage_b["jtr"]
    params = jax.tree.map(jnp.asarray, jtr.state.params)
    trainable, frozen = jax_optim.partition_params(params, jtr.partial_keywords)
    steps = JaxSteps(jtr)
    out = {}
    for i, layout in enumerate(LAYOUTS):
        ttr, arrays = stage_b[layout]["ttr"], stage_b[layout]["arrays"]
        rng = np.random.default_rng(10 + i)
        img_idx = torch.from_numpy(rng.integers(0, len(arrays["images"]), (1,)))
        ray_idx = torch.from_numpy(rng.permutation(SIZE[0] * SIZE[1])[:ttr.cfg.model.render.rand_rays][None])
        batch = ttr.gather_batch({k: torch.from_numpy(v) for k, v in arrays.items()}, img_idx, ray_idx)
        assert batch["pseudo_ref_sampled"].shape == (1, ray_idx.shape[1], 3)
        jgrads, jlosses = steps.grads(trainable, frozen, {k: v.numpy() for k, v in batch.items()}, 0)
        tlosses, tgrads = _port_loss_grads(ttr, batch)
        start = {k: v.clone() for k, v in ttr.model.state_dict().items()}
        calls = []
        original = hashgrid_scatter.scatter_add_rows
        hashgrid_scatter.scatter_add_rows = lambda *a: calls.append(1) or original(*a)
        try:
            info = ttr.train_step(batch)
        finally:
            hashgrid_scatter.scatter_add_rows = original
        jgrads = jax.tree.map(lambda g: None if g is None else np.asarray(g), jgrads, is_leaf=lambda x: x is None)
        out[layout] = dict(jlosses=jlosses, tlosses=tlosses, tgrads=tgrads, start=start, info=info,
                           ttr=ttr, scatter_calls=len(calls), jgrads=params_from_jax(jgrads))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_b_step_losses_match_jax(one_step, layout):
    """Every loss and the total at the configs' weights (intrinsic and
    regularize_re 1.0) within its bound; the port's train step logs the
    values its loss function gave."""
    r = one_step[layout]
    want, got = r["jlosses"], r["tlosses"]
    assert sorted(got) == sorted(want) == ["curvature", "eikonal", "intrinsic", "regularize_re", "render", "total"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=SDF_RTOL.get(key, LOSS_RTOL), err_msg=key)
    for key, value in r["info"]["losses"].items():
        np.testing.assert_allclose(float(value), got[key], rtol=1e-6, err_msg=key)
    assert got["intrinsic"] > 0 and np.isfinite(got["regularize_re"])
    weights = r["ttr"].cfg.trainer.loss_weight
    assert (weights.intrinsic, weights.regularize_re) == (1.0, 1.0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_b_step_head_grads_match_jax(one_step, layout):
    """Only the radiance heads train (the rgb_r_s heads with shading_dim
    1); each head leaf's gradient within 1e-4 of its largest entry."""
    r = one_step[layout]
    cfg = r["ttr"].cfg.model.object.rgb
    assert (cfg.network_mode, cfg.shading_dim) == ("rgb_r_s", 1)
    names = sorted(r["tgrads"])
    assert names and all(n.startswith("neural_rgb.") for n in names)
    assert any(".mlp_r." in n for n in names) and any(".mlp_s." in n for n in names)
    assert sorted(k for k in r["jgrads"] if k.startswith("neural_rgb.")) == names
    for name in names:
        got, want = r["tgrads"][name].double().numpy(), r["jgrads"][name].double().numpy()
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= GRAD_RTOL * scale, f"{name}: {err:.3g} > {GRAD_RTOL} * {scale:.3g}"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_b_step_keeps_the_sdf(one_step, layout):
    """The step moves the heads; the SDF, its hash tables and s_var stay
    bitwise as they were; no table-gradient scatter runs."""
    r = one_step[layout]
    state = r["ttr"].model.state_dict()
    moved = 0
    for name, value in state.items():
        if name.startswith("neural_rgb."):
            moved += int((value != r["start"][name]).sum())
        else:
            assert torch.equal(value, r["start"][name]), name
    assert moved > 0
    assert any(n.startswith("neural_sdf.hash_table.") for n in state)
    assert r["scatter_calls"] == 0 and float(r["info"]["table_grad_norm"]) == 0.0
