"""The port's data-parallel training (mlinerf_tpu_torch/parallel/distributed.py
and the trainer's combine) on two gloo ranks on the CPU, against the JAX
package at the TINY size.

Two ranks (tests/torch_dist_worker.py) train from the same bridged JAX
params on the same injected global batches (midpoint samples, so the step
draws nothing):

* ``grad_psum: True`` (DDP) against the JAX step whose gradient is the mean
  of the two half batches' (JAX's ``shard_map`` + ``pmean``, written out
  with ``value_and_grad`` on each half);
* ``grad_psum: False`` (the global layout) against the JAX step on the
  whole batch: stage a, and stage b, whose weighted-shading and intrinsic
  losses normalize over the batch;
* ``shard_tables`` against replicated, a ``"bf16"`` combine, the policy
  cases of tests/test_grad_psum.py, and one rank bitwise against the step
  without a process group;
* a dispatch window of three steps through ``run_window`` (DDP) against
  the same JAX steps, its parameters and window means;
* the step body that NCCL ranks capture in a CUDA graph, for each layout,
  run under ``torch_parity.watch_host_reads``: no host read, no tensor of
  host data. The ranks here are gloo, whose steps stay eager; the rule
  that decides capture is held on its own.

Tolerances are those of tests/test_torch_train_step.py for the same
quantities (the bf16 tables to bf16 rounding).
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as workers
from torch_parity import (CONFIG, JaxSteps, assert_close_to_leaf_max, bf16_ulp, configs, injected_batch,
                          tiny_args)

from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.data.synthetic import Dataset as TorchDataset
from mlinerf_tpu_torch.parallel import distributed as pdist
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

STAGE_B = "configs/syn_sphere_b.yaml"
# Stage b without the warm start and the label file (the labels ride in the
# injected batches); lr(0) > 0, so both steps move the heads.
B_EXTRA = ["--model.use_pre_trained=", "--data.train.pseudo_label.enabled!", "--optim.sched.warm_up_end=0"]
DICT13 = ["--model.object.sdf.encoding.hashgrid.dict_size=13"]  # 8192 rows: tables to shard
STEPS = 2
WINDOW = 3  # steps of the run_window case


def _open_encoding(params, rng):
    """Open the SDF MLP's encoding columns, so the tables get gradient."""
    params = jax.tree.map(np.asarray, params)
    kernel = np.array(params["neural_sdf"]["mlp"]["linear_0"]["kernel"])
    kernel[3:] = rng.normal(0, 0.3, kernel[3:].shape)
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"] = kernel
    return params


def _stage_b_batches(arrays, rng, rays):
    out = []
    for _ in range(STEPS):
        batch = injected_batch(arrays, rng, rays)
        batch["pseudo_ref_sampled"] = rng.uniform(0, 1.2, (1, rays, 3)).astype(np.float32)
        batch["pseudo_sha_sampled"] = rng.uniform(0, 1, (1, rays, 1)).astype(np.float32)
        batch["pseudo_visibility_certainty_sampled"] = rng.uniform(0, 1, (1, rays, 1)).astype(np.float32)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results beside the JAX package's and the one-process
    port's. The ranks run while the JAX side computes."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    jcfg, tcfg = configs()
    jcfg.runtime.mesh = "none"
    jtr = JaxTrainer(jcfg, seed=0, logdir=str(tmp / "jax_a"))
    params_a = _open_encoding(jtr.state.params, rng)
    arrays = TorchDataset(tcfg).as_arrays()
    rays = tcfg.model.render.rand_rays
    batches_a = [injected_batch(arrays, rng, rays) for _ in range(STEPS)]
    jcfg_b, _ = configs(*B_EXTRA, config=STAGE_B)
    jcfg_b.runtime.mesh = "none"
    jtr_b = JaxTrainer(jcfg_b, seed=0, logdir=str(tmp / "jax_b"))
    params_b = jax.tree.map(np.asarray, jtr_b.state.params)
    batches_b = _stage_b_batches(arrays, rng, rays)
    # dict 13 from the port's own seed-0 init, encoding columns opened.
    ttr13 = TorchTrainer(configs(*DICT13)[1], seed=0, logdir=str(tmp / "port13"), device="cpu")
    with torch.no_grad():
        w = ttr13.model.neural_sdf.mlp.linear_0.weight
        w[:, 3:] = torch.from_numpy(rng.normal(0, 0.3, tuple(w[:, 3:].shape)).astype(np.float32))
    state13 = {k: v.clone() for k, v in ttr13.model.state_dict().items()}
    odd = [injected_batch(arrays, rng, 63) for _ in range(STEPS)]
    batches_w = [injected_batch(arrays, rng, rays) for _ in range(WINDOW)]

    def case(name, runtime, config=CONFIG, extra=(), state=params_from_jax(params_a), batches=batches_a, **kw):
        return dict(name=name, config=config, args=tiny_args(*extra), runtime=runtime, state=state, batches=batches,
                    **kw)

    suite = dict(cases=[
        case("ddp", {"grad_psum": True}),
        case("global", {"grad_psum": False}),
        case("global_b", {"grad_psum": False}, config=STAGE_B, extra=B_EXTRA, state=params_from_jax(params_b),
             batches=batches_b),
        case("bf16", {"grad_psum": "bf16"}),
        case("replicated13", {"grad_psum": False}, extra=DICT13, state=state13),
        case("sharded13", {"shard_tables": True}, extra=DICT13, state=state13),
        case("odd", {"grad_psum": True}, extra=["--model.render.rand_rays=63"], batches=odd),
        case("ddp_window", {"grad_psum": True}, batches=batches_w, window=True),
        case("ddp_steps3", {"grad_psum": True}, batches=batches_w),
    ], policy=dict(config=CONFIG, args=tiny_args(), cases={
        "auto": {}, "auto_shard_tables": {"shard_tables": True},
        "explicit_shard_tables": {"grad_psum": True, "shard_tables": True}, "mesh_none": {"mesh": "none"}}),
        capture=dict(cases=[dict(c, batches=None) for c in (
            case("ddp", {"grad_psum": True}), case("bf16", {"grad_psum": "bf16"}),
            case("global", {"grad_psum": False}),
            case("sharded13", {"shard_tables": True}, extra=DICT13, state=state13))]),
        auto=dict(config=CONFIG, args=tiny_args("--trainer.steps_per_dispatch=auto", "--max_iter=5",
                                                "--logging_iter=5")))
    two = workers.Ranks(2, str(tmp / "two"), "suite", suite)
    one = workers.Ranks(1, str(tmp / "one"), "train_cases",
                        dict(cases=[case("today", {"mesh": "none"}), case("ddp_world1", {"grad_psum": True})]))

    jax_steps, jax_steps_b = JaxSteps(jtr), JaxSteps(jtr_b)
    want = {"ddp": jax_steps.run(params_a, batches_a, split=2), "global": jax_steps.run(params_a, batches_a, split=1),
            "global_b": jax_steps_b.run(params_b, batches_b, split=1),
            "ddp_window": jax_steps.run(params_a, batches_w, split=2)}
    return dict(two=two.join(), one=one.join()[0], want=want, lr=float(jtr.lr_fn(1)),
                start_b=params_from_jax(params_b), state13=state13)


def _assert_params_close(got, want, lr, within_ulp=0.99):
    """float32 leaves within 1e-6; bf16 tables: ``within_ulp`` of the
    entries within one bf16 ulp, every entry within one ulp plus 4 x the
    learning rate (the JAX path accumulates a table's gradient in bf16; a
    gradient that bf16 nearly cancels can turn Adam's step;
    test_torch_train_step.py)."""
    for name, w in want.items():
        p = got[name]
        assert p.dtype == w.dtype, name
        if p.dtype == torch.bfloat16:
            diff = (p.float() - w.float()).abs()
            ulp = bf16_ulp(p, w)
            assert float((diff <= ulp).float().mean()) >= within_ulp, name
            assert torch.all(diff <= ulp + 4 * lr), name
        else:
            np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)


def _assert_logged_close(got, want, rtol=None):
    """The logged total and every loss within 1e-5 relative (``rtol``
    names other bounds), per step."""
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=(rtol or {}).get(k, 1e-5), err_msg=k)


@pytest.mark.parametrize("layout", ["ddp", "global", "global_b"])
def test_layout_matches_jax(runs, layout):
    """DDP against JAX's mean of the half batches' gradients; the global
    layout against JAX's whole-batch step (stage b: its coupled losses take
    the whole batch's normalization).

    The global layout's table gradient is the bf16 mean of the ranks' bf16
    gradients: one rounding more than JAX's whole-batch step, as JAX's own
    partitioned program sums its devices' bf16 partial tables. JAX's
    whole-batch and half-batch-mean steps themselves agree to one ulp on
    98.8% of the entries of the finest table here, so the global layout's
    band is 98% (every entry still within one ulp plus 4 x lr). Stage b's
    curvature is the finite-difference Laplacian of the frozen
    geometric-init SDF, a cancellation: the port's one-process step differs
    from JAX's by up to 2.4e-5 of it on these batches, so 5e-5 there (it
    reaches no trainable parameter)."""
    got = runs["two"][0][layout]
    want_params, _, want_logged = runs["want"][layout]
    _assert_logged_close(got["logged"], want_logged, rtol={"curvature": 5e-5} if layout == "global_b" else None)
    _assert_params_close(got["params"], want_params, runs["lr"], within_ulp=0.99 if layout == "ddp" else 0.98)
    assert got["global_layout"] == (layout != "ddp") and got["world"] == 2


@pytest.mark.parametrize("layout", ["ddp", "global"])
def test_layout_moments_match_jax(runs, layout):
    """Adam's moments: float32 leaves within 1e-3 of the leaf max, the bf16
    tables' within 25% (test_torch_train_step.py's bounds)."""
    got = runs["two"][0][layout]["opt_state"]
    _, want, _ = runs["want"][layout]
    adam = want[0]
    names = list(runs["two"][0][layout]["params"])
    jmu = params_from_jax(jax.tree.map(np.asarray, adam.mu))
    jnu = params_from_jax(jax.tree.map(np.asarray, adam.nu))
    trainable = [n for n in names if n in jmu]
    assert got["count"] == int(adam.count) == STEPS
    for name, mu, nu in zip(trainable, got["mu"], got["nu"]):
        tol = 0.25 if nu.dtype == torch.bfloat16 else 1e-3
        assert_close_to_leaf_max(mu.float().numpy(), jmu[name].float().numpy(), tol, name)
        assert_close_to_leaf_max(nu.float().numpy(), jnu[name].float().numpy(), tol, name)


def test_stage_b_moves_heads_only(runs):
    """Stage b across ranks: everything but the radiance heads stays bitwise
    as it started; the heads move."""
    got, start = runs["two"][0]["global_b"]["params"], runs["start_b"]
    moved = 0
    for name, p in got.items():
        if name.startswith("neural_rgb."):
            moved += int((p != start[name]).sum())
        else:
            assert torch.equal(p, start[name].to(p.dtype)), name
    assert moved > 0
    assert {"intrinsic", "regularize_re"} <= set(runs["two"][0]["global_b"]["logged"][0])


@pytest.mark.parametrize("case", ["ddp", "global", "global_b", "bf16", "replicated13", "sharded13", "odd",
                                  "ddp_window"])
def test_ranks_agree_bitwise(runs, case):
    """Both ranks end every case with the same parameters, bit for bit, and
    log the same values."""
    r0, r1 = runs["two"][0][case], runs["two"][1][case]
    assert r0["logged"] == r1["logged"]
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name


def test_window_matches_jax(runs):
    """A window of three steps through ``run_window`` on two ranks (DDP,
    each step on the next injected batch) against JAX's ``shard_map`` +
    ``pmean`` steps: the window means of the total and of every loss within
    1e-5 of the mean of JAX's per-step values; float32 parameters within
    1e-6 and every bf16 table entry within one ulp plus 4 x lr.

    The layout test's band (99% of a table's entries within one ulp) is a
    two-step figure: each step adds the entries whose bf16-rounded gradient
    turns Adam's step, so over three steps 97.3-99.3% of each table's
    entries are within one ulp here. The window is held instead bitwise to
    the same three steps run one by one (``train_step``), whose first two
    that band holds (test_layout_matches_jax)."""
    got, steps = runs["two"][0]["ddp_window"], runs["two"][0]["ddp_steps3"]
    want_params, _, want_logged = runs["want"]["ddp_window"]
    means = got["logged"]
    assert len(want_logged) == WINDOW and sorted(means["losses"]) == sorted(k for k in want_logged[0] if k != "total")
    np.testing.assert_allclose(means["total"], np.mean([w["total"] for w in want_logged]), rtol=1e-5)
    for k, v in means["losses"].items():
        np.testing.assert_allclose(v, np.mean([w[k] for w in want_logged]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(v, np.mean([w[k] for w in steps["logged"]]), rtol=1e-6, err_msg=k)
    assert np.isfinite(means["grad_norm"]) and means["grad_norm"] > 0
    _assert_params_close(got["params"], want_params, runs["lr"], within_ulp=0.0)
    for name, p in steps["params"].items():
        assert torch.equal(got["params"][name], p), name
    assert got["opt_state"]["count"] == steps["opt_state"]["count"] == WINDOW


@pytest.mark.parametrize("layout", ["ddp", "bf16", "global", "sharded13"])
def test_rank_step_reads_nothing_on_the_host(runs, layout):
    """The body that NCCL ranks capture (``_window_step``: the rank's slice,
    the combine, ``reduce_info``, the global layout's gathered rays, the
    sharded tables' reduce-scatter and row all-gather), after a warm-up
    step, on both ranks: no host read of a tensor and no tensor of host
    data (tests/test_torch_window_capture.py's check)."""
    for rank in range(2):
        got = runs["two"][rank]["capture"][layout]
        assert got["reads"] == [] and got["made"] == [], (rank, got["reads"], got["made"])
    got = runs["two"][0]["capture"][layout]
    assert got["gathers_rays"] == (layout in ("global", "sharded13"))
    assert (got["sharded"] > 0) == (layout == "sharded13")


def test_auto_window_is_one_size_on_every_rank(runs):
    """``steps_per_dispatch: auto`` across ranks: the window is sized once,
    from rank 0's timed window, on every rank (the graphs' buffers and keys
    follow the window, and every rank must capture the same ones); the
    eager gloo steps time a window as replays would."""
    lines = [[w for w in runs["two"][r]["auto"] if w.startswith("[trainer] auto steps_per_dispatch")]
             for r in range(2)]
    assert len(lines[0]) == 1 and lines[0] == lines[1], lines
    window = [w for w in runs["two"][0]["auto"] if w.startswith("[window]")]
    assert window == ["[window] 2 ranks (gloo, cpu): windows of up to 1 steps run as eager steps (gloo runs its "
                      "collectives on the host, which a CUDA graph cannot capture)"], window


def test_gloo_ranks_step_eagerly(runs):
    """gloo ranks run their steps eagerly (no graph could hold gloo's host
    collectives); the step without a process group goes through the
    graphs, as on one process."""
    assert all(not c["graph_steps"] for name, c in runs["two"][0].items() if name not in ("policy", "capture", "auto"))
    assert runs["one"]["today"]["graph_steps"] and not runs["one"]["ddp_world1"]["graph_steps"]


@pytest.mark.parametrize("backend, device, captures", [
    ("nccl", "cuda", True), ("nccl", "cuda:1", True), ("gloo", "cuda", False), ("gloo", "cpu", False),
    ("nccl", "cpu", False), (None, "cuda", False)])
def test_capture_rule(monkeypatch, backend, device, captures):
    """``captures_collectives``: an NCCL group on a CUDA device captures
    its steps (and sets NCCL_GRAPH_MIXING_SUPPORT=1 where it is unset);
    gloo on either device, and no group, stay eager."""
    monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: backend is not None)
    monkeypatch.setattr(pdist.dist, "get_backend", lambda group=None: backend)
    assert pdist.captures_collectives(torch.device(device)) is captures
    assert os.environ.get("NCCL_GRAPH_MIXING_SUPPORT") == ("1" if captures else None)


@pytest.mark.parametrize("env", [{"NCCL_GRAPH_MIXING_SUPPORT": "0"}, {"TORCH_NCCL_BLOCKING_WAIT": "1"},
                                 {"NCCL_BLOCKING_WAIT": "true"}])
def test_capture_refuses_contrary_nccl_env(monkeypatch, env):
    """A setting under which a captured collective cannot run beside eager
    ones (graph mixing off, or a blocking wait, which polls the collective
    from the host) raises where the group would capture; an explicit
    NCCL_GRAPH_MIXING_SUPPORT=1 is kept."""
    for key in ("NCCL_GRAPH_MIXING_SUPPORT", "TORCH_NCCL_BLOCKING_WAIT", "NCCL_BLOCKING_WAIT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pdist.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(RuntimeError, match="NCCL_GRAPH_MIXING_SUPPORT"):
        pdist.captures_collectives("cuda")
    monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", "1")
    for key in ("TORCH_NCCL_BLOCKING_WAIT", "NCCL_BLOCKING_WAIT"):
        monkeypatch.delenv(key, raising=False)
    assert pdist.captures_collectives("cuda")


def test_shard_tables_matches_replicated(runs):
    """ZeRO row sharding (reduce-scatter, each rank updating its rows, the
    table all-gathered) gives the replicated global layout's parameters and
    moments exactly; the sharded tables' moments hold half their rows."""
    rep, zero = runs["two"][0]["replicated13"], runs["two"][0]["sharded13"]
    assert zero["sharded"] and not rep["sharded"]
    assert all(".hash_table." in n for n in zero["sharded"])
    assert all(rows == zero["params"][n].shape[0] // 2 for n, rows in zero["moment_rows"].items())
    assert zero["grad_psum"] is False and zero["global_layout"]
    assert rep["logged"] == zero["logged"]
    for name, p in rep["params"].items():
        assert torch.equal(p, zero["params"][name]), name
    for key in ("mu", "nu"):
        for a, b in zip(rep["opt_state"][key], zero["opt_state"][key]):
            assert torch.equal(a, b), key
    assert all(not torch.equal(zero["params"][n], runs["state13"][n]) for n in zero["sharded"])


def test_bf16_combine_stays_finite(runs):
    """``grad_psum: "bf16"`` combines the gradients in bf16: finite losses
    and parameters, close to the float32 combine."""
    got, ref = runs["two"][0]["bf16"], runs["two"][0]["ddp"]
    assert all(np.isfinite(v) for step in got["logged"] for v in step.values())
    assert all(torch.isfinite(p.float()).all() for p in got["params"].values())
    np.testing.assert_allclose(got["logged"][-1]["total"], ref["logged"][-1]["total"], rtol=5e-2)


def test_non_divisible_rays_warn_and_train(runs):
    """63 rays on 2 ranks: the batch stays whole on every rank, the warning
    says so once, and the step trains."""
    got = runs["two"][0]["odd"]
    assert got["stdout"].count("[grad_psum] WARNING") == 1
    assert all(np.isfinite(step["total"]) for step in got["logged"])


@pytest.mark.parametrize("name, want", [
    ("auto", dict(grad_psum=True, world=2, dp=True)),
    ("auto_shard_tables", dict(grad_psum=False, world=2, dp=True)),
    ("mesh_none", dict(grad_psum=False, world=1, dp=False)),
])
def test_grad_psum_policy(runs, name, want):
    """tests/test_grad_psum.py's policy: auto is DDP on more than one rank,
    defers to shard_tables, and is off without a mesh."""
    for rank in range(2):
        assert runs["two"][rank]["policy"][name] == want


def test_grad_psum_conflicts_with_shard_tables(runs):
    assert "mutually exclusive" in runs["two"][0]["policy"]["explicit_shard_tables"]["error"]


def test_world_size_one_is_bitwise_todays_step(runs):
    """One rank with grad_psum True (the all-reduce over one rank runs)
    ends bitwise where the step without a mesh (no combine, one
    generator: the step as it was) ends, in the same process."""
    got, today = runs["one"]["ddp_world1"], runs["one"]["today"]
    assert got["world"] == today["world"] == 1 and got["grad_psum"] is True and today["global_layout"] is None
    assert got["logged"] == today["logged"]
    for name, p in today["params"].items():
        assert torch.equal(p, got["params"][name]), name


def test_shard_rays_slices_the_ray_axis():
    batch = {"idx": torch.zeros(2), "ray_idx": torch.arange(16).view(2, 8), "image_sampled": torch.rand(2, 8, 3),
             "pose": torch.rand(2, 3, 4)}
    part, sharded = pdist.shard_rays(batch, world=4, this_rank=1)
    assert sharded and torch.equal(part["ray_idx"], batch["ray_idx"][:, 2:4])
    assert torch.equal(part["image_sampled"], batch["image_sampled"][:, 2:4]) and part["pose"] is batch["pose"]
    whole, sharded = pdist.shard_rays(batch, world=3, this_rank=1)
    assert not sharded and whole is batch


def test_single_gpu_refuses_a_launchers_world(monkeypatch):
    """``runtime.mesh: none`` (``--single_gpu``) under a launcher that
    started two ranks raises; alone it joins nothing."""
    cfg = {"runtime": {"mesh": "none"}}
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        pdist.init_distributed(cfg, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert pdist.init_distributed(cfg, "cpu") == (torch.device("cpu"), False)


def test_rendezvous_from_multihost_mapping(monkeypatch):
    """The mapping form of ``runtime.multihost`` names the world (JAX's
    ``init_multihost`` keys); the launcher's environment overrides it; with
    neither there is no world to join."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    mh = {"runtime": {"multihost": {"coordinator_address": "10.0.0.7:1234", "num_processes": 4, "process_id": 3}}}
    assert pdist._rendezvous(mh) == ("10.0.0.7", 1234, 4, 3, 0)
    assert pdist._rendezvous({"runtime": {"multihost": True}}) is None
    assert pdist.init_distributed({"runtime": {}}, "cpu") == (torch.device("cpu"), False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_PORT", "4321")
    assert pdist._rendezvous(mh) == ("10.0.0.7", 4321, 2, 1, 1)


def test_multihost_mapping_brings_up_one_process(tmp_path):
    """``init_distributed`` from the mapping alone, one process on the CPU
    (gloo): the group is up, this process is rank 0 of 1 and main; a second
    call takes the group as it is."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = f"""
import os
for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
    os.environ.pop(key, None)
from mlinerf_tpu_torch.parallel import distributed as pdist
cfg = {{"runtime": {{"multihost": {{"coordinator_address": "127.0.0.1:{port}", "num_processes": 1,
                                   "process_id": 0}}}}}}
device, created = pdist.init_distributed(cfg, "cpu")
assert created and pdist.is_initialized() and pdist.world_size() == 1 and pdist.is_main_process()
assert pdist.init_distributed(cfg, "cpu") == (device, False)
pdist.sync_processes("done")
pdist.dist.destroy_process_group()
print("MAPPING_OK")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert "MAPPING_OK" in r.stdout, (r.stdout, r.stderr[-2000:])
