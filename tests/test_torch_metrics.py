"""The port's quality metrics (mlinerf_tpu_torch/pipelines/metrics.py) and
PNG reader (utils/image_io.load_image) against the JAX package's, on the
CPU: MSE, PSNR and SSIM within 1e-12 (float64), LPIPS on weights made from
a seed within 1e-5, the missing-weights rules, the reader on PIL's files,
on each PNG row filter and on the port's own writer, and the harness on a
TINY ``image_test`` dump."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from test_lpips import _fixture_npz
from torch_parity import configs

from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu.pipelines import metrics as J
from mlinerf_tpu.utils.image_io import load_image as jax_load_image
from mlinerf_tpu_torch.config import resolve
from mlinerf_tpu_torch.pipelines import inference as torch_inference
from mlinerf_tpu_torch.pipelines import metrics as T
from mlinerf_tpu_torch.utils.image_io import load_image, save_image, to_uint8


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)


@pytest.fixture()
def no_lpips_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    if T.lpips_weights_path() is not None:
        pytest.skip("assets/lpips_alex.npz is present")


@pytest.mark.parametrize("shape", [(37, 53, 3), (31, 29), (64, 48, 1), (8, 9, 3)])
def test_mse_psnr_ssim_match_jax(shape):
    a, b = _pair(shape)
    for name in ("mse", "psnr", "ssim"):
        got, want = getattr(T, name)(a, b, device="cpu"), getattr(J, name)(a, b)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (name, got, want)


def test_ssim_valid_window_ignores_the_border():
    """The valid 7x7 box filter equals scipy's reflect-padded filter
    cropped by 3: a border that only the padding would see changes
    neither."""
    a, b = _pair((40, 44, 3), seed=1, noise=0.3)
    a[:3], b[-3:, :, 0] = 1.0, 0.0
    assert abs(T.ssim(a, b, device="cpu") - J.ssim(a, b)) <= 1e-12
    assert 0 < T.ssim(a, b, device="cpu") < 1


@pytest.mark.parametrize("with_alpha,gamma", [(False, None), (True, None), (False, 2.2), (True, 2.2)])
def test_calculate_metrics_matches_jax(with_alpha, gamma, no_lpips_weights):
    a, b = _pair((33, 35, 3), seed=2)
    alpha = np.random.default_rng(3).uniform(0, 1, (33, 35, 1)).astype(np.float32) if with_alpha else None
    got = T.calculate_metrics(a * 1.2 - 0.1, b, alpha=alpha, gamma=gamma, device="cpu")
    want = J.calculate_metrics(a * 1.2 - 0.1, b, alpha=alpha, gamma=gamma)
    assert sorted(got) == sorted(want) == ["lpips", "mse", "psnr", "ssim"]
    assert got["lpips"] is None and want["lpips"] is None
    for k in ("mse", "psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), (k, got[k], want[k])


@pytest.fixture()
def seed_weights(tmp_path, monkeypatch):
    path = str(tmp_path / "lpips_seed.npz")
    _fixture_npz(path)
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    monkeypatch.setattr(J, "_LPIPS_CACHE", {})
    monkeypatch.setattr(T, "_LPIPS_CACHE", {})
    return path


@pytest.mark.parametrize("shape", [(64, 64, 3), (71, 83, 3)])
def test_lpips_matches_jax(shape, seed_weights):
    a, b = _pair(shape, seed=4, noise=0.15)
    got, want = T.lpips(a, b, device="cpu"), J.lpips(a, b)
    assert got is not None and np.isfinite(got)
    assert abs(got - want) <= 1e-5, (got, want)
    assert abs(T.lpips(a, a, device="cpu")) < 1e-6


def test_lpips_missing_weights_warns_once(no_lpips_weights, monkeypatch, capsys):
    monkeypatch.setattr(T, "_LPIPS_WARNED", False)
    img = np.zeros((8, 8, 3), np.float32)
    assert T.lpips(img, img, device="cpu") is None
    err = capsys.readouterr().err
    assert "LPIPS" in err and "export_lpips_weights.py" in err
    assert T.lpips(img, img, device="cpu") is None
    assert "LPIPS" not in capsys.readouterr().err


def test_metrics_cli_refuses_without_weights(no_lpips_weights):
    with pytest.raises(SystemExit, match="LPIPS"):
        T.main(["--config", "configs/syn_sphere_a.yaml", "--output_dir", "/nonexistent", "--device", "cpu"])


def test_metrics_cli_asks_for_cuda(no_lpips_weights):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--config", "configs/syn_sphere_a.yaml", "--output_dir", "/nonexistent", "--allow_missing_lpips"])


# ---------------------------------------------------------------------------
# The PNG reader
# ---------------------------------------------------------------------------


def _gradient_image(h, w, c, seed=0):
    """Smooth ramps plus noise: every filter sees non-trivial neighbours."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3 + 40 * k) % 256 for k in range(c)], -1)
    return ((base + rng.integers(0, 30, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_reads_pil_files(mode, tmp_path):
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = _gradient_image(37, 45, c, seed=c)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img[..., 0] if c == 1 else img, mode).save(path)
    got = load_image(path)
    assert got.dtype == np.float32 and got.shape == (37, 45, c)
    np.testing.assert_array_equal(got, jax_load_image(path))


def _encode_png(img, filters):
    """An 8-bit PNG of img [H,W,C] with row y filtered by filters[y]."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    prior, raw = np.zeros(w * c, np.int64), b""
    for y in range(h):
        x, f = rows[y], filters[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        p = a + prior - up_left
        pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, up_left))
        pred = [np.zeros_like(x), a, prior, (a + prior) // 2, paeth][f]
        raw += bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reader_undoes_each_filter(filt, channels, tmp_path):
    img = _gradient_image(23, 19, channels, seed=5)
    names = ["none", "sub", "up", "average", "paeth"]
    filters = [y % 5 for y in range(23)] if filt == "mixed" else [names.index(filt)] * 23
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, filters))
    np.testing.assert_array_equal(load_image(str(path)), img.astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(load_image(str(path)), jax_load_image(str(path)))


def test_png_reader_reads_the_port_writer(tmp_path):
    img = np.random.default_rng(6).uniform(0, 1, (21, 17, 3)).astype(np.float32)
    path = str(tmp_path / "own.png")
    save_image(path, img)
    np.testing.assert_array_equal(load_image(path), to_uint8(img).astype(np.float32) / np.float32(255.0))


# Each mode's colour type at a bit depth the PNG specification does not
# allow for it (Pillow refuses each too): palette at 16 bits, grey at 3,
# grey+alpha at 4.
_INVALID_LAYOUT = {"P": (16, 3), "I;16": (3, 0), "LA": (4, 4)}


@pytest.mark.parametrize("mode", ["P", "I;16", "LA"])
def test_png_reader_rejects_other_formats(mode, tmp_path):
    """The mode itself reads as the JAX package reads it (bitwise); its
    colour type at a bit depth PNG does not define raises."""
    path = str(tmp_path / "other.png")
    Image.new(mode, (8, 8)).save(path)
    np.testing.assert_array_equal(load_image(path), jax_load_image(path))
    depth, ctype = _INVALID_LAYOUT[mode]
    data = bytearray(open(path, "rb").read())
    data[24:26] = bytes([depth, ctype])  # the IHDR's bit depth and colour type
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(path, "wb").write(bytes(data))
    with pytest.raises(Exception):
        Image.open(path).load()
    with pytest.raises(ValueError, match="PNG"):
        load_image(path)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_test_dump(tmp_path_factory):
    """The stage-b TINY model's image_test dump (rgb, o_r and o_s maps of
    the 4 validation images) and both packages' configs."""
    from mlinerf_tpu_torch.trainers.lumen import Trainer as TorchTrainer

    jcfg, tcfg = configs("--model.use_pre_trained!", "--data.train.pseudo_label.enabled!",
                         config="configs/syn_sphere_b.yaml")
    out = str(tmp_path_factory.mktemp("image_test"))
    ttr = TorchTrainer(tcfg, is_inference=True, seed=0, logdir=out, device="cpu")
    dataset = resolve("dataset", tcfg.data.type)(tcfg, is_inference=True)
    torch_inference.test_save(ttr, dataset, out)
    return jcfg, tcfg, out


def test_evaluate_outputs_matches_jax(image_test_dump, no_lpips_weights):
    jcfg, tcfg, out = image_test_dump
    comps = ("rgb", "ref", "sha")
    got = T.evaluate_outputs(out, resolve("dataset", tcfg.data.type)(tcfg, is_inference=True),
                             tcfg.data.val.image_size, components=comps, device="cpu")
    want = J.evaluate_outputs(out, jax_resolve("dataset", jcfg.data.type)(jcfg, is_inference=True),
                              jcfg.data.val.image_size, components=comps)
    assert sorted(got) == sorted(want) == sorted(comps)
    for comp in comps:
        assert sorted(got[comp]) == sorted(want[comp]) == ["mse", "psnr", "ssim"], comp
        for k, v in want[comp].items():
            assert abs(got[comp][k] - v) <= 1e-9, (comp, k, got[comp][k], v)


def test_metrics_cli_on_the_dump(image_test_dump, no_lpips_weights, capsys):
    _, tcfg, out = image_test_dump
    from torch_parity import DETERMINISTIC, TINY

    results = T.main(["--config", "configs/syn_sphere_b.yaml", "--output_dir", out, "--components", "rgb,ref,sha",
                      "--allow_missing_lpips", "--device", "cpu", "--model.use_pre_trained!",
                      "--data.train.pseudo_label.enabled!", *TINY, *DETERMINISTIC])
    assert sorted(results) == ["ref", "rgb", "sha"]
    assert all(np.isfinite(v) for comp in results.values() for v in comp.values())
    assert '"psnr"' in capsys.readouterr().out


def test_evaluate_method_outputs_matches_jax(tmp_path, no_lpips_weights):
    """Ground truth with an alpha matte in the Img file, predictions in the
    'ours' layout."""
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir(), pred_dir.mkdir()
    rng = np.random.default_rng(8)
    for i in range(3):
        rgba = _gradient_image(24, 26, 4, seed=10 + i)
        Image.fromarray(rgba, "RGBA").save(gt_dir / f"{i:03d}_Img.png")
        for comp, key in (("Ref", "o_r"), ("Sha", "o_s"), ("Img", "rgb")):
            if comp != "Img":
                Image.fromarray(_gradient_image(24, 26, 3, seed=20 + i)).save(gt_dir / f"{i:03d}_{comp}.png")
            Image.fromarray(rng.integers(0, 256, (24, 26, 3)).astype(np.uint8)).save(pred_dir / f"{i}_{key}_map.png")
    comps = ("Img", "Ref", "Sha")
    got = T.evaluate_method_outputs(str(pred_dir), str(gt_dir), components=comps, num_images=4, device="cpu")
    want = J.evaluate_method_outputs(str(pred_dir), str(gt_dir), components=comps, num_images=4)
    for comp in comps:
        assert sorted(got[comp]) == sorted(want[comp]) == ["mse", "psnr", "ssim"], comp
        for k, v in want[comp].items():
            assert abs(got[comp][k] - v) <= 1e-12 * max(1.0, abs(v)), (comp, k)


def test_method_layouts_match_jax():
    assert sorted(T.METHOD_LAYOUTS) == sorted(J.METHOD_LAYOUTS)
    for method, layout in J.METHOD_LAYOUTS.items():
        for comp in ("Img", "Ref", "Sha"):
            for i in (0, 7, 123):
                try:
                    want = layout("d", comp, i)
                except KeyError:
                    with pytest.raises(KeyError):
                        T.METHOD_LAYOUTS[method]("d", comp, i)
                    continue
                assert T.METHOD_LAYOUTS[method]("d", comp, i) == want, (method, comp, i)


def test_run_synthetic_pipeline_and_metrics(tmp_path, no_lpips_weights, monkeypatch):
    """The five steps and the metrics in one process at a tiny size; the
    seed reaches both training steps."""
    from mlinerf_tpu_torch import run_synthetic, train
    from torch_parity import TINY

    small = [a for a in TINY if "image_size" not in a] + ["--data.train.image_size=[16,16]",
                                                         "--data.val.image_size=[16,16]"]
    train_argvs, train_main = [], train.main
    monkeypatch.setattr(train, "main", lambda argv: train_argvs.append(argv) or train_main(argv))
    result = run_synthetic.main(["--logroot", str(tmp_path), "--device", "cpu", "--max_iter=2", "--logging_iter=1",
                                 "--validation_iter=2", "--seed", "1", *small])
    assert result["seed"] == 1 and [argv[argv.index("--seed") + 1] for argv in train_argvs] == ["1", "1"]
    assert list(result["seconds"]) == ["train_a", "render_a", "pseudo_label", "train_b", "image_test_b", "metrics_b"]
    assert sorted(result["scores"]) == ["ref", "rgb", "sha"]
    assert all(np.isfinite(v) for comp in result["scores"].values() for v in comp.values())
    assert result["last_validation"]["a"]["step"] == 2 and "val/psnr_ref" in result["last_validation"]["b"]
    assert (tmp_path / "syn_sphere_b" / "run_synthetic.json").exists()
