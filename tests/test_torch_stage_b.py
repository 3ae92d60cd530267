"""The port's stage-b training against the JAX package's at the TINY size:
the three stage-b losses and their gradients, the partial-training
partition, and one step of a stage-b trainer warm-started from a JAX
stage-a checkpoint, from an injected batch that carries pseudo labels;
the val branch of the losses, and the pseudo labels in the dataset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, injected_batch, jax_stage_a_checkpoint

from mlinerf_tpu.data.synthetic import Dataset as JaxDataset
from mlinerf_tpu.trainers import optim as jax_optim
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu.utils import losses as jax_losses
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.ops import hashgrid_scatter
from mlinerf_tpu_torch.pipelines.label_store import save_results_all
from mlinerf_tpu_torch.trainers import optim as torch_optim
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer
from mlinerf_tpu_torch.utils import losses as torch_losses

SMALL = ["--data.train.image_size=[16,16]", "--data.val.image_size=[16,16]", "--model.render.rand_rays_val=128",
         # lr(0) > 0, so that the one step moves the heads.
         "--optim.sched.warm_up_end=0"]


def stage_configs(stage, *extra):
    return configs(*SMALL, *extra, config=f"configs/syn_sphere_{stage}.yaml")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _loss_inputs(name, rng):
    R = 200
    if name == "weighted_shading":
        return [rng.uniform(0, 1, (1, R, 1)), rng.uniform(0, 1, (1, R, 1))], {"weight_range": (0.1, 1.0)}
    if name == "intrinsic":
        args = [rng.uniform(0, 1, (1, R, 3)), rng.uniform(0, 1, (1, R, 1)), rng.uniform(0, 1.5, (1, R, 3)),
                rng.uniform(0, 1, (1, R, 1)), rng.uniform(0, 1, (1, R, 1))]
        return args, dict(weight_map_range_shading=(0.25, 1.0), weight_map_range_visibility=(0.0, 1.0),
                          factor_ref=1.0, factor_sha=0.5)
    return [rng.normal(0, 0.2, (1, R, 3))], dict(factor_negative=10.0, factor_positive=1.0, exponent_positive=2.0)


@pytest.mark.parametrize("name", ["weighted_shading", "intrinsic", "regularize_re"])
def test_stage_b_loss_and_grads_match_jax(name):
    """Value within 1e-6 relative and the gradient of every input within
    1e-6 of its largest entry (measured: 9.2e-8 and 6.8e-8 at most)."""
    args, kwargs = _loss_inputs(name, np.random.default_rng(0))
    args = [a.astype(np.float32) for a in args]
    jfn, tfn = getattr(jax_losses, f"{name}_loss"), getattr(torch_losses, f"{name}_loss")
    want, jgrads = jax.value_and_grad(lambda *a: jfn(*a, **kwargs), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = tfn(*targs, **kwargs)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for t, g in zip(targs, jgrads):
        g = np.asarray(g)
        grad = np.zeros_like(g) if t.grad is None else t.grad.numpy()  # None: used only detached
        np.testing.assert_allclose(grad, g, rtol=0, atol=1e-6 * max(np.abs(g).max(), 1e-30))


# ---------------------------------------------------------------------------
# Warm start, one step, validation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_a_checkpoint(tmp_path_factory):
    return jax_stage_a_checkpoint(stage_configs("a")[0], str(tmp_path_factory.mktemp("stage_a")))


@pytest.fixture(scope="module")
def stage_b(stage_a_checkpoint, tmp_path_factory):
    """Both packages' stage-b trainers warm-started from that checkpoint;
    the port then takes the JAX trainer's params, so both start equal
    (the heads the checkpoint lacks start from each package's own draws)."""
    warm = f"--model.use_pre_trained.pt_filename={stage_a_checkpoint}"
    jcfg, tcfg = stage_configs("b", warm)
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp_path_factory.mktemp("jax_b")))
    ttr = TorchTrainer(tcfg, seed=0, logdir=str(tmp_path_factory.mktemp("port_b")), device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    assert any(".mlp_r." in n for n in ttr.warm_start_report["missing"])
    return dict(jtr=jtr, ttr=ttr)


def _jax_partial_step(jtr, params, batch):
    """The JAX package's train step with partial training (trainers/base.py
    ``_train_step_fn``) at iteration 0, run eagerly: op by op, as the port
    runs, so that the comparison sees no fusion's rounding."""
    it = jnp.asarray(0, jnp.int32)
    cond = dict(jtr.make_cond(it))
    cond["max_levels"] = jtr.static_max_levels_for(0)
    weights = jtr.loss_weights_at(it, cond)
    trainable0, frozen = jax_optim.partition_params(params, jtr.partial_keywords)
    key = jax.random.PRNGKey(0)

    def loss_fn(trainable, frozen, batch):
        out = jtr.model.apply({"params": jax_optim.merge_params(trainable, frozen)}, batch, cond, key, train=True)
        loss_dict, _ = jtr.compute_loss(out, batch, mode="train")
        total = jnp.zeros((), jnp.float32)
        for k, v in loss_dict.items():
            if k in weights:
                total = total + weights[k] * v
        return total, loss_dict

    (total, loss_dict), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable0, frozen, batch)
    updates, _ = jtr.tx.update(grads, jtr.tx.init(trainable0), trainable0)
    new = jax.tree.map(lambda p, u: None if p is None else p + u.astype(p.dtype), trainable0, updates,
                       is_leaf=lambda x: x is None)
    return jax_optim.merge_params(new, frozen), float(total), {k: float(v) for k, v in loss_dict.items()}


@pytest.fixture(scope="module")
def one_step(stage_b):
    jtr, ttr = stage_b["jtr"], stage_b["ttr"]
    rng = np.random.default_rng(1)
    _, tcfg_a = stage_configs("a")
    batch = injected_batch(TorchDataset(tcfg_a).as_arrays(), rng, ttr.cfg.model.render.rand_rays)
    R = batch["ray_idx"].shape[1]
    batch["pseudo_ref_sampled"] = rng.uniform(0, 1.2, (1, R, 3)).astype(np.float32)
    batch["pseudo_sha_sampled"] = rng.uniform(0, 1, (1, R, 1)).astype(np.float32)
    batch["pseudo_visibility_certainty_sampled"] = rng.uniform(0, 1, (1, R, 1)).astype(np.float32)
    start = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    params = jax.tree.map(np.asarray, jtr.state.params)
    jparams, jtotal, jlosses = _jax_partial_step(jtr, jax.tree.map(jnp.asarray, params),
                                                 {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []
    original = hashgrid_scatter.scatter_add_rows
    hashgrid_scatter.scatter_add_rows = lambda *a: calls.append(1) or original(*a)
    try:
        info = ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    finally:
        hashgrid_scatter.scatter_add_rows = original
    return dict(jtr=jtr, ttr=ttr, start=start, info=info, jtotal=jtotal, jlosses=jlosses, scatter_calls=len(calls),
                jparams=params_from_jax(jax.tree.map(np.asarray, jparams)))


def test_one_step_losses_match_jax(one_step):
    """All five losses within 1e-5 relative (measured: 6.7e-6 in the
    eikonal term of the frozen SDF, 1.6e-7 at most in the others)."""
    got = {k: float(v) for k, v in one_step["info"]["losses"].items()}
    want = one_step["jlosses"]
    assert sorted(got) == sorted(want) == ["curvature", "eikonal", "intrinsic", "regularize_re", "render"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(one_step["info"]["total"]), one_step["jtotal"], rtol=1e-5)


def test_one_step_updates_heads_only(one_step):
    """The radiance heads move as JAX's do: within 1e-6 (measured: 2.9e-7;
    the step is about lr = 1e-3 per entry). Everything else (the SDF, its tables,
    s_var) is bitwise unchanged; no table has a gradient and the
    table-gradient scatter never ran; the optimizer holds the heads only."""
    ttr, start, want = one_step["ttr"], one_step["start"], one_step["jparams"]
    moved = 0
    for name, p in ttr.model.state_dict().items():
        if name.startswith("neural_rgb."):
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
            moved += int((p != start[name]).sum())
        else:
            assert torch.equal(p, start[name]) and torch.equal(p, want[name].to(p.dtype)), name
    assert moved > 0
    for name, p in ttr.model.named_parameters():
        assert p.requires_grad == name.startswith("neural_rgb."), name
    assert all(t.grad is None for t in ttr.model.neural_sdf.hash_table)
    assert one_step["scatter_calls"] == 0
    assert all(n.startswith("neural_rgb.") for n in ttr.trainable_names)
    # As many optimizer leaves as the JAX package's optax state.
    jtr = one_step["jtr"]
    trainable, _ = jax_optim.partition_params(jtr.state.params, jtr.partial_keywords)
    assert len(ttr.optimizer.mu) == len(ttr.trainable_names) == len(jax.tree.leaves(trainable))
    assert float(one_step["info"]["table_grad_norm"]) == 0.0


def test_partition_matches_jax_keywords():
    """The same keywords select the same leaves in both packages' names."""
    names = ["neural_rgb.mlp_r.linear_0.weight", "neural_sdf.hash_table.0", "s_var", "neural_rgb.mlp.linear_1.g"]
    for kw in (["neural_rgb"], ["neural_rgb/mlp_r"], ["hash_table/0", "s_var"]):
        got = torch_optim.trainable_mask([(n, None) for n in names], kw)
        want = [jax_optim.param_path_matches(n.split("."), kw) for n in names]
        assert got == want, kw
    trainable, frozen = torch_optim.partition_params([(n, None) for n in names], ["neural_rgb"])
    assert [n for n, _ in trainable] == [names[0], names[3]] and [n for n, _ in frozen] == names[1:3]


def test_val_branch_losses_match_jax(stage_b):
    """``compute_loss(mode="val")`` on full-image maps: the L1 render loss,
    PSNR and the residual regularizer of ``o_re_map``, within 1e-6
    relative (measured: 2.7e-7 in the render loss, 0 in the others)."""
    jtr, ttr = stage_b["jtr"], stage_b["ttr"]
    rng = np.random.default_rng(2)
    output = {"rgb": rng.uniform(size=(1, 16, 16, 3)), "rgb_map": rng.uniform(size=(1, 16, 16, 3)),
              "o_re_map": rng.normal(0, 0.1, (1, 16, 16, 3))}
    batch = {"image": rng.uniform(size=(1, 16, 16, 3))}
    output, batch = ({k: v.astype(np.float32) for k, v in d.items()} for d in (output, batch))
    jl, jm = jtr.compute_loss({k: jnp.asarray(v) for k, v in output.items()},
                              {k: jnp.asarray(v) for k, v in batch.items()}, mode="val")
    tl, tm = ttr.compute_loss({k: torch.from_numpy(v) for k, v in output.items()},
                              {k: torch.from_numpy(v) for k, v in batch.items()}, mode="val")
    assert sorted(tl) == sorted(jl) == ["regularize_re", "render"] and sorted(tm) == sorted(jm)
    for got, want in ((tl, jl), (tm, jm)):
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_dataset_pseudo_labels_match_jax(stage_b, tmp_path):
    """Both packages' synthetic datasets read one ``pseudo_label_all.npz``
    into the same arrays (frame i: camera str(i), light "0"), and the
    port's batch carries them per picked ray."""
    rng = np.random.default_rng(3)
    store = {str(i): {"pseudo_reflectance": rng.uniform(size=(16, 16, 3)),
                      **{str(li): {"pseudo_shading_gamma": rng.uniform(size=(16, 16, 1)),
                                   "visibility_certainty": rng.uniform(size=(16, 16, 1))} for li in range(4)}}
             for i in range(4)}
    save_results_all(store, str(tmp_path / "pseudo_label_all"))
    jcfg, tcfg = stage_configs("b", f"--data.train.pseudo_label.pt_file={tmp_path / 'pseudo_label_all.npz'}")
    want, got = JaxDataset(jcfg).as_arrays(), TorchDataset(tcfg).as_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["pseudo_sha"][2], store["2"]["0"]["pseudo_shading_gamma"].astype(np.float32))
    ttr = stage_b["ttr"]
    img_idx, ray_idx = torch.tensor([2]), torch.tensor([[0, 17, 255]])
    batch = ttr.gather_batch({k: torch.from_numpy(v) for k, v in got.items()}, img_idx, ray_idx)
    np.testing.assert_array_equal(batch["pseudo_ref_sampled"][0].numpy(),
                                  got["pseudo_ref"][2].reshape(256, 3)[[0, 17, 255]])
    assert batch["pseudo_visibility_certainty_sampled"].shape == (1, 3, 1)
