"""``python -m mlinerf_tpu_torch.extract_pose_points`` against the JAX
package's ``scripts/extract_pose_points.py`` on configs/syn_sphere_a.yaml:
the PLY of each split, byte for byte."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mlinerf_tpu_torch import extract_pose_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "syn_sphere_a.yaml")


@pytest.mark.parametrize("split", ["train", "val"])
def test_ply_equals_the_jax_scripts(split, tmp_path):
    want_path, got_path = tmp_path / "jax.ply", tmp_path / "port.ply"
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "extract_pose_points.py"), "--config", CONFIG,
                    "--split", split, "--output", str(want_path)],
                   check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    verts = extract_pose_points.main(["--config", CONFIG, "--split", split, "--output", str(got_path)])
    assert got_path.read_bytes() == want_path.read_bytes()
    header = got_path.read_text().split("end_header\n")[0]
    assert f"element vertex {len(verts)}\n" in header and "element face 0\n" in header
    assert np.isfinite(verts).all() and len(verts) > 0
