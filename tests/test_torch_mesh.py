"""The port's mesh extraction (mlinerf_tpu_torch/ops/mesh.py,
pipelines/mesh_extract.py, extract_mesh.py) against the JAX package's, on
the CPU: the port's own marching-tets library against the plain version,
welding and the PLY writer, the block-wise pipeline on analytic SDFs, the
largest-component filter, the SDF and texture probes of a bridged TINY
model, and the CLI on a TINY checkpoint.

The JAX package's pipeline is run with the port's triangulator swapped in,
so no test here builds or loads ``native/libmarching_tets.so``; the
triangulator itself is held against the JAX package's plain version."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import DETERMINISTIC, TINY, configs, perturb_jax_params

from mlinerf_tpu.ops import mesh as jax_mesh_ops
from mlinerf_tpu.pipelines import mesh_extract as jax_mesh_extract
from mlinerf_tpu.trainers.lumen import Trainer as JaxTrainer
from mlinerf_tpu_torch import extract_mesh as mesh_cli
from mlinerf_tpu_torch.bridge import params_from_jax
from mlinerf_tpu_torch.ops import cuda_build
from mlinerf_tpu_torch.ops import mesh as mesh_ops
from mlinerf_tpu_torch.pipelines import mesh_extract
from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sphere_field(n=33, radius=10.0, center=16.0):
    g = np.arange(n) - center
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(X**2 + Y**2 + Z**2) - radius).astype(np.float32)


def _sorted_tris(tris):
    """Triangles as rows of their sorted vertices, in a canonical order
    (the plain version winds some cases the other way round)."""
    verts = np.round(tris, 4)
    order = np.lexsort(verts.transpose(2, 0, 1)[::-1], axis=-1)  # per triangle, by x, then y, then z
    rows = np.take_along_axis(tris, order[..., None], axis=1).reshape(len(tris), 9)
    return rows[np.lexsort(np.round(rows, 4).T[::-1])]


@pytest.fixture()
def port_triangulator_in_jax(monkeypatch):
    monkeypatch.setattr(jax_mesh_ops, "marching_tets", mesh_ops.marching_tets)


def test_marching_tets_sphere_radius():
    tris = mesh_ops.marching_tets(sphere_field(), 0.0)
    assert len(tris) > 1000
    r = np.linalg.norm(tris.mean(axis=1) - 16.0, axis=-1)
    np.testing.assert_allclose(r.mean(), 10.0, atol=0.05)
    assert r.std() < 0.05


@pytest.mark.parametrize("n,radius,center", [(17, 5.0, 8.0), (21, 6.3, 9.7), (12, 9.0, 0.0)])
def test_native_matches_plain_marching(n, radius, center):
    """The same triangles from the C++ library, the port's plain version
    and the JAX package's."""
    field = sphere_field(n, radius, center)
    native = mesh_ops.marching_tets(field, 0.0)
    plain = mesh_ops._marching_tets_numpy(field, 0.0)
    jax_plain = jax_mesh_ops._marching_tets_numpy(field, 0.0)
    assert len(native) == len(plain) == len(jax_plain) > 0
    np.testing.assert_allclose(_sorted_tris(native), _sorted_tris(plain), atol=1e-5)
    np.testing.assert_array_equal(_sorted_tris(plain), _sorted_tris(jax_plain))


def test_library_builds_into_build_not_native():
    mesh_ops.marching_tets(sphere_field(9, 3.0, 4.0), 0.0)
    assert (cuda_build.CSRC_DIR / "marching_tets.cpp").exists()
    assert "marching_tets" not in cuda_build.kernel_names()  # not on the nvcc route
    lib = cuda_build.library_path("marching_tets")
    assert lib.exists() and lib.parent == cuda_build.BUILD_DIR
    assert os.path.realpath(mesh_ops._get_lib()._name) == os.path.realpath(str(lib))
    assert "native" not in str(lib.relative_to(ROOT))


def test_weld_and_ply_match_jax(tmp_path):
    tris = mesh_ops.marching_tets(sphere_field(n=17, radius=5.0, center=8.0), 0.0)
    verts, faces = mesh_ops.weld_vertices(tris)
    jverts, jfaces = jax_mesh_ops.weld_vertices(tris)
    assert len(verts) < 3 * len(faces)  # welding shares vertices
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    colors = np.random.default_rng(0).integers(0, 256, (len(verts), 3)).astype(np.uint8)
    for c in (None, colors):
        mesh_ops.save_ply(str(tmp_path / "port.ply"), verts, faces, c)
        jax_mesh_ops.save_ply(str(tmp_path / "jax.ply"), jverts, jfaces, c)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def _sphere_sdfs(center, radius):
    c = np.asarray(center, np.float32)
    return (lambda p: torch.linalg.norm(p - torch.from_numpy(c), dim=-1) - radius,
            lambda p: jnp.linalg.norm(p - jnp.asarray(c), axis=-1) - radius)


@pytest.mark.parametrize("resolution,block_res", [(48, 20), (40, 40), (33, 128)])
def test_extract_mesh_analytic_matches_jax(resolution, block_res, port_triangulator_in_jax):
    torch_sdf, jax_sdf = _sphere_sdfs((0.1, -0.05, 0.0), 0.5)
    kwargs = dict(resolution=resolution, block_res=block_res, sphere_radius=2.0, sphere_center=(1.0, 0.0, 0.0))
    verts, faces, colors = mesh_extract.extract_mesh(torch_sdf, (-1, -1, -1), (1, 1, 1), device="cpu", **kwargs)
    jverts, jfaces, _ = jax_mesh_extract.extract_mesh(jax_sdf, (-1, -1, -1), (1, 1, 1), **kwargs)
    assert colors is None and len(faces) > 100
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-6)
    r = np.linalg.norm(verts - np.asarray([1.2, -0.1, 0.0]), axis=-1)
    np.testing.assert_allclose(r.mean(), 1.0, atol=0.02)


def test_lattice_blocks_match_jax():
    got = list(mesh_extract.lattice_blocks((-1, -0.5, -1), (1, 1, 0.7), 37, 16))
    want = list(jax_mesh_extract.lattice_blocks((-1, -0.5, -1), (1, 1, 0.7), 37, 16))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_filter_largest_cc():
    """Two disjoint triangles: the larger one stays."""
    verts = np.asarray([[0, 0, 0], [2, 0, 0], [0, 2, 0], [5, 5, 5], [5.1, 5, 5], [5, 5.1, 5]], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]])
    v2, f2 = mesh_extract.filter_largest_cc(verts, faces)
    np.testing.assert_array_equal(v2, verts[:3])
    np.testing.assert_array_equal(f2, [[0, 1, 2]])


def test_filter_largest_cc_two_spheres_matches_jax(port_triangulator_in_jax):
    def torch_sdf(p):
        d1 = torch.linalg.norm(p - torch.tensor([0.4, 0, 0]), dim=-1) - 0.35
        d2 = torch.linalg.norm(p + torch.tensor([0.55, 0, 0]), dim=-1) - 0.12
        return torch.minimum(d1, d2)

    def jax_sdf(p):
        d1 = jnp.linalg.norm(p - jnp.asarray([0.4, 0, 0]), axis=-1) - 0.35
        d2 = jnp.linalg.norm(p + jnp.asarray([0.55, 0, 0]), axis=-1) - 0.12
        return jnp.minimum(d1, d2)

    kw = dict(resolution=40, block_res=40)
    all_verts, _, _ = mesh_extract.extract_mesh(torch_sdf, device="cpu", **kw)
    verts, faces, _ = mesh_extract.extract_mesh(torch_sdf, filter_lcc=True, device="cpu", **kw)
    jverts, jfaces, _ = jax_mesh_extract.extract_mesh(jax_sdf, filter_lcc=True, **kw)
    assert len(verts) < len(all_verts) and len(faces) > 50
    np.testing.assert_allclose(np.linalg.norm(verts - np.asarray([0.4, 0, 0]), axis=-1), 0.35, atol=0.05)
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The trainer probes and the CLI
# ---------------------------------------------------------------------------

ITERATION = 700


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """A JAX TINY inference trainer with perturbed params at ITERATION, and
    the port's trainer with the same params."""
    jcfg, tcfg = configs()
    jtr = JaxTrainer(jcfg, is_inference=True, seed=0, logdir=str(tmp_path_factory.mktemp("jax")))
    params = perturb_jax_params(jtr.state.params, np.random.default_rng(0))
    params["neural_sdf"]["mlp"]["linear_0"]["kernel"][3:] *= 0.2
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    ttr = TorchTrainer(tcfg, is_inference=True, seed=0, logdir=str(tmp_path_factory.mktemp("port")), device="cpu")
    ttr.model.load_state_dict(params_from_jax(params))
    jtr.current_iteration = ttr.current_iteration = ITERATION
    return jtr, ttr


def test_trainer_sdf_fn_matches_jax(bridged):
    jtr, ttr = bridged
    pts = np.random.default_rng(1).uniform(-1, 1, (4096, 3)).astype(np.float32)
    with torch.no_grad():
        got = mesh_extract.trainer_sdf_fn(ttr)(torch.from_numpy(pts)).numpy()
    want = np.asarray(jax_mesh_extract.trainer_sdf_fn(jtr)(jnp.asarray(pts)))
    assert got.shape == want.shape == (4096,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_trainer_texture_fn_matches_jax(bridged, port_triangulator_in_jax):
    """Vertex colours of the model's own surface, within 1 of 255."""
    jtr, ttr = bridged
    verts, _, colors = mesh_extract.extract_mesh(
        mesh_extract.trainer_sdf_fn(ttr), resolution=32, block_res=32,
        texture_fn=mesh_extract.trainer_texture_fn(ttr), device="cpu")
    assert len(verts) > 100 and colors.dtype == np.uint8 and colors.shape == verts.shape
    rgb = np.asarray(jax_mesh_extract.trainer_texture_fn(jtr)(jnp.asarray(verts)))
    want = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    assert int(np.abs(colors.astype(int) - want.astype(int)).max()) <= 1


def test_lattice_sdf_of_bridged_model_matches_jax(bridged):
    jtr, ttr = bridged
    (_, pts), = list(mesh_extract.lattice_blocks((-1, -1, -1), (1, 1, 1), 24, 24))
    flat = pts.reshape(-1, 3)
    got = mesh_extract._evaluate(mesh_extract.trainer_sdf_fn(ttr), flat, 4096, torch.device("cpu"))
    want = np.asarray(jax_mesh_extract.trainer_sdf_fn(jtr)(jnp.asarray(flat)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_checkpoint(bridged, tmp_path_factory):
    _, ttr = bridged
    logdir = tmp_path_factory.mktemp("mesh_cli")
    ttr.checkpointer = type(ttr.checkpointer)(ttr.cfg, str(logdir))
    ttr.save_checkpoint(ITERATION, latest=True)
    return logdir


def test_mesh_cli_on_tiny_checkpoint(bridged, tiny_checkpoint):
    _, ttr = bridged
    out, verts, faces, colors = mesh_cli.main(
        ["--config", "configs/syn_sphere_a.yaml", "--logdir", str(tiny_checkpoint), "--device", "cpu",
         "--resolution", "32", "--block_res", "16", "--textured", *TINY, *DETERMINISTIC])
    assert out == os.path.join(str(tiny_checkpoint), "mesh.ply") and os.path.exists(out)
    with open(out) as f:
        header = f.read(400)
    assert f"element vertex {len(verts)}" in header and f"element face {len(faces)}" in header
    assert "property uchar red" in header and colors.shape == verts.shape and len(faces) > 100
    # The CLI evaluates the checkpoint at its iteration: the same mesh as
    # the trainer's own probes.
    want, wfaces, wcolors = mesh_extract.extract_mesh(
        mesh_extract.trainer_sdf_fn(ttr), resolution=32, block_res=16,
        texture_fn=mesh_extract.trainer_texture_fn(ttr), device="cpu")
    np.testing.assert_array_equal(faces, wfaces)
    np.testing.assert_array_equal(verts, want)
    np.testing.assert_array_equal(colors, wcolors)


def test_mesh_cli_asks_for_cuda(tiny_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_cli.main(["--config", "configs/syn_sphere_a.yaml", "--logdir", str(tiny_checkpoint), *TINY])
