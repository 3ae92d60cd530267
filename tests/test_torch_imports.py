"""The PyTorch port imports nothing of JAX, flax, optax or the JAX package,
and neither Pillow nor OpenCV."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mlinerf_tpu")
NOT_ON_THE_CARD = ("PIL", "cv2")
PORT_FILES = sorted((ROOT / "mlinerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_quality.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_pil_or_opencv(path):
    """The card's machine has neither Pillow nor OpenCV."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in NOT_ON_THE_CARD]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    assert len(PORT_FILES) > 20
    assert (ROOT / "mlinerf_tpu_torch" / "csrc" / "scatter_add_rows.cu").exists()
    assert (ROOT / "mlinerf_tpu_torch" / "csrc" / "marching_tets.cpp").exists()
    assert (ROOT / "mlinerf_tpu_torch" / "csrc" / "png_unfilter.cpp").exists()
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("pipelines/metrics.py", "pipelines/mesh_extract.py", "ops/mesh.py", "extract_mesh.py",
                   "run_synthetic.py", "data/lumen.py", "data/lumen_blender.py", "data/blender.py",
                   "data/fixtures.py", "utils/image_io.py", "pipelines/inference.py", "data/llff.py",
                   "models/nerf.py", "models/ingp.py", "trainers/nerf.py", "models/fields.py",
                   "models/neuralangelo.py", "utils/camera.py", "parallel/distributed.py", "utils/console.py",
                   "utils/profiling.py", "utils/hemisphere.py", "pipelines/indirect_light.py", "bench.py",
                   "extract_pose_points.py"):
        assert f"mlinerf_tpu_torch/{module}" in names, module
