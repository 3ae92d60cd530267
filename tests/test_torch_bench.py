"""The port's benchmark (``python -m mlinerf_tpu_torch.bench``) against the
JAX package's ``bench.py``: the config of every ``BENCH_CONFIG`` name,
alone and with ``BENCH_*`` knobs, equal key for key; then one
``BENCH_SMALL`` run on the CPU prints one JSON line with ``bench.py``'s
keys."""

import contextlib
import io
import json

import pytest

import bench as jax_bench
from mlinerf_tpu_torch import bench

# The keys bench.py prints, in its order.
KEYS = ["metric", "value", "unit", "vs_baseline", "vs_target_2x_a100", "render_rays_per_sec",
        "attainable_rays_per_sec", "vs_attainable", "config", "semantics_delta_vs_reference", "steps_per_dispatch",
        "window_times_s"]
KNOBS = {"BENCH_SHARED_LEVELS": "auto", "BENCH_DICT_SIZE": "18", "BENCH_COARSE": "48", "BENCH_FINE": "8",
         "BENCH_HIER": "3", "BENCH_LEVELS": "12", "BENCH_DIM": "4", "BENCH_SDF_WIDTH": "128",
         "BENCH_HESS_MODE": "exact", "BENCH_HESS_FRACTION": "0.5", "BENCH_DENSE_BLOCKED": "1",
         "BENCH_SAMPLING_LEVELS": "6", "BENCH_MESH": "none", "BENCH_FREEZE": "tables", "BENCH_CORNER_SAMPLE": "1",
         "BENCH_CORNER_FLOOR": "0.2", "BENCH_CORNER_MODE": "center", "BENCH_CORNER_EXACT_FINEST": "2",
         "BENCH_TABLE_LR_SCALE": "1.5", "BENCH_TOPK": "12", "BENCH_TOPK_STRIDE": "4"}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in list(KNOBS) + ["BENCH_CONFIG", "BENCH_SMALL", "BENCH_SPD"]:
        monkeypatch.delenv(var, raising=False)


def test_names_are_bench_py_names():
    assert bench.DEFAULT_CONFIG == jax_bench.DEFAULT_CONFIG
    assert bench.BASELINE_RAYS_PER_SEC == jax_bench.BASELINE_RAYS_PER_SEC == 18_000


@pytest.mark.parametrize("name", bench.CONFIGS)
def test_config_matches_bench_py(name, monkeypatch):
    monkeypatch.setenv("BENCH_CONFIG", name)
    assert bench.build_bench_cfg().to_dict() == jax_bench.build_bench_cfg().to_dict()


@pytest.mark.parametrize("name", ["reference", "composedautoslev4blk", "composed12", "tuned"])
def test_knobs_match_bench_py(name, monkeypatch):
    monkeypatch.setenv("BENCH_CONFIG", name)
    for var, value in KNOBS.items():
        monkeypatch.setenv(var, value)
    got, want = bench.build_bench_cfg(), jax_bench.build_bench_cfg()
    assert got.to_dict() == want.to_dict()
    assert got.model.object.sdf.encoding.hashgrid.dict_size == 18


def test_unknown_names_raise(monkeypatch):
    monkeypatch.setenv("BENCH_CONFIG", "fastest")
    with pytest.raises(SystemExit, match="unknown BENCH_CONFIG=fastest"):
        bench.build_bench_cfg()
    monkeypatch.setenv("BENCH_CONFIG", "reference")
    monkeypatch.setenv("BENCH_FREEZE", "rgb")
    with pytest.raises(SystemExit, match="unknown BENCH_FREEZE=rgb"):
        bench.build_bench_cfg()


@pytest.mark.parametrize("name,shared,window", [
    ("composedautoslev4blk", None, 32), ("composed12", None, 32), ("reference", "auto", 32), ("tuned", None, 16),
    ("lvl12", None, 16), ("budget", None, 8), ("reference", None, 5), ("reference", "0", 5)])
def test_default_window_is_bench_py_table(name, shared, window, monkeypatch):
    """Without BENCH_SPD the window is bench.py's default for the config
    (bench.py main: 32 with the stencil or a composed config, 16 tuned and
    lvl12, 8 budget, else 5)."""
    monkeypatch.setenv("BENCH_CONFIG", name)
    if shared is not None:
        monkeypatch.setenv("BENCH_SHARED_LEVELS", shared)
    assert bench.default_window() == window


def test_small_run_prints_bench_py_line(monkeypatch):
    """BENCH_SMALL on the CPU, 2 timed windows of BENCH_SPD=2 steps and one
    timed render: one JSON line, bench.py's keys in its order, the window it
    ran, the default config's delta."""
    for var, value in (("BENCH_SMALL", "1"), ("BENCH_ITERS", "2"), ("BENCH_RENDER_REPEATS", "1"),
                       ("BENCH_SPD", "2")):
        monkeypatch.setenv(var, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--device", "cpu"])
    lines = [line for line in out.getvalue().splitlines() if line.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == KEYS
    assert line["metric"] == "train_rays_per_sec" and line["unit"] == "rays/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 18_000, 3)
    assert line["render_rays_per_sec"] > 0 and len(line["window_times_s"]) == 2
    assert line["attainable_rays_per_sec"] is None and line["vs_attainable"] is None
    assert line["config"] == "composedautoslev4blk" and line["steps_per_dispatch"] == 2
    assert line["semantics_delta_vs_reference"]["dict_size"] == "22 -> 15"
    assert line["semantics_delta_vs_reference"]["shared_levels"] == "0 -> auto"
