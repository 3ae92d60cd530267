"""The PyTorch port imports nothing of JAX, flax, optax or the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mlinerf_tpu")
PORT_FILES = sorted((ROOT / "mlinerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_scan_sees_the_package():
    assert len(PORT_FILES) > 20
    assert (ROOT / "mlinerf_tpu_torch" / "csrc" / "scatter_add_rows.cu").exists()
    assert (ROOT / "mlinerf_tpu_torch" / "csrc" / "marching_tets.cpp").exists()
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("pipelines/metrics.py", "pipelines/mesh_extract.py", "ops/mesh.py", "extract_mesh.py",
                   "run_synthetic.py"):
        assert f"mlinerf_tpu_torch/{module}" in names, module
