"""Quality metrics: PSNR, SSIM, LPIPS and MSE, per component (RGB,
reflectance, shading), over this framework's renders and other methods'.

The metrics of the JAX package's ``pipelines/metrics.py``, on the device:

* ``mse``, ``psnr`` and ``ssim`` reduce in float64 (the H100 runs float64
  at full IEEE precision). SSIM is skimage's ``structural_similarity`` with
  its defaults (uniform 7x7 window, sample covariance, channel-averaged),
  which crops the window radius from every border before the mean. The
  crop removes exactly the pixels whose window reaches the border padding,
  so a *valid* 7x7 box filter (``avg_pool2d`` without padding) gives the
  cropped map directly, and the padding mode never matters.
* LPIPS is the AlexNet-backbone metric in float32, with the weights read
  from the same ``.npz`` (``$LPIPS_WEIGHTS``, else ``assets/lpips_alex.npz``
  at the repo root); without them it warns once and is ``None``.
* The float32 preparation of the images (clip, compositing over white,
  the shading gamma) stays on the host in numpy, as the reference computes
  it: numpy's float32 power and torch's round a fifth of all values to
  different neighbours, which would move the scores by more than their
  float64 rounding.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mlinerf_tpu_torch.utils.image_io import load_image
from mlinerf_tpu_torch.utils.misc import get_device


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device).to(torch.float64)


def mse(pred, gt, device=None) -> float:
    device = get_device(device)
    return float(torch.mean((_f64(pred, device) - _f64(gt, device)) ** 2))


def psnr(pred, gt, data_range: float = 1.0, device=None) -> float:
    m = mse(pred, gt, device=device)
    return float(10 * np.log10(data_range**2 / max(m, 1e-12)))


def ssim(pred, gt, data_range: float = 1.0, win_size: int = 7, device=None) -> float:
    """Mean SSIM over a [H,W] or [H,W,C] pair, skimage-compatible: the
    mean of the per-channel means over the valid window positions."""
    device = get_device(device)
    x, y = _f64(pred, device), _f64(gt, device)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    x, y = x.permute(2, 0, 1)[:, None], y.permute(2, 0, 1)[:, None]  # [C,1,H,W]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size**2
    cov_norm = NP / (NP - 1)

    def filt(t):
        return F.avg_pool2d(t, win_size, stride=1)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    return float(S.mean(dim=(1, 2, 3)).mean())


# ---------------------------------------------------------------------------
# LPIPS (AlexNet backbone, weights from npz)
# ---------------------------------------------------------------------------

# (weights path, device) -> {name: tensor}; the convolutions as OIHW.
_LPIPS_CACHE: Dict[tuple, Dict[str, torch.Tensor]] = {}

# AlexNet feature extractor: (out_ch, kernel, stride, pad); a ReLU tap after
# each convolution, a 3x3/2 max pool after the first two.
_ALEX_LAYERS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_weights_path() -> Optional[str]:
    for cand in (
        os.environ.get("LPIPS_WEIGHTS", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "assets", "lpips_alex.npz"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


_LPIPS_WARNED = False


def _warn_lpips_missing() -> None:
    """One warning per process when LPIPS is asked for but the AlexNet
    weights are absent: the reference always scores LPIPS."""
    global _LPIPS_WARNED
    if _LPIPS_WARNED:
        return
    _LPIPS_WARNED = True
    sys.stderr.write(
        "\n[metrics] WARNING: LPIPS weights not found — LPIPS will be MISSING "
        "from this run's results.\n"
        "[metrics]   Export them on any torch+lpips host with\n"
        "[metrics]     python scripts/export_lpips_weights.py --out assets/lpips_alex.npz\n"
        "[metrics]   then copy assets/lpips_alex.npz here (or set LPIPS_WEIGHTS=/path/to.npz).\n\n"
    )


@contextlib.contextmanager
def _no_tf32():
    """cuDNN may run float32 convolutions in TF32 (PyTorch's default),
    which moves LPIPS by about 1e-3; turn it off for the metric."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _lpips_weights(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    key = (path, str(device))
    if key not in _LPIPS_CACHE:
        with np.load(path) as data:
            weights = {}
            for i in range(len(_ALEX_LAYERS)):
                # conv{i}_w is HWIO, lin{i}_w [1,1,C,1]: both to OIHW.
                for name in (f"conv{i}_w", f"lin{i}_w"):
                    weights[name] = torch.from_numpy(np.ascontiguousarray(data[name].transpose(3, 2, 0, 1)))
                weights[f"conv{i}_b"] = torch.from_numpy(data[f"conv{i}_b"].reshape(-1))
        _LPIPS_CACHE[key] = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
    return _LPIPS_CACHE[key]


def _alex_features(weights, img: np.ndarray, device: torch.device):
    x = torch.as_tensor(np.asarray(img, np.float32), device=device).permute(2, 0, 1)[None]
    shift = torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=device).view(1, 3, 1, 1)
    x = (x * 2.0 - 1.0 - shift) / scale
    feats = []
    for i, (_out, _k, stride, pad) in enumerate(_ALEX_LAYERS):
        x = F.relu(F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"], stride=stride, padding=pad))
        feats.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def lpips(pred, gt, device=None) -> Optional[float]:
    """LPIPS(AlexNet) of two [H,W,3] images in [0,1] (the reference's
    ``lpips.LPIPS(net='alex')`` with normalize=True); None if the weights
    are missing."""
    path = lpips_weights_path()
    if path is None:
        _warn_lpips_missing()
        return None
    device = get_device(device)
    weights = _lpips_weights(path, device)
    with torch.no_grad(), _no_tf32():
        f0, f1 = _alex_features(weights, pred, device), _alex_features(weights, gt, device)
        total = torch.zeros((), device=device)
        for i in range(len(_ALEX_LAYERS)):
            a = f0[i] / (torch.linalg.vector_norm(f0[i], dim=1, keepdim=True) + 1e-10)
            b = f1[i] / (torch.linalg.vector_norm(f1[i], dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(F.conv2d((a - b) ** 2, weights[f"lin{i}_w"]))
    return float(total)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


def composite_white(img: np.ndarray, alpha: Optional[np.ndarray]) -> np.ndarray:
    if alpha is None:
        return img
    return img * alpha + (1.0 - alpha)


def calculate_metrics(pred, gt, alpha: Optional[np.ndarray] = None, gamma: Optional[float] = None,
                      device=None) -> Dict[str, Optional[float]]:
    """All four metrics of one [H,W,3] pair. ``alpha`` [H,W,1]: both images
    composite over white; ``gamma``: x^(1/gamma) on both (shading)."""
    pred = np.clip(np.asarray(pred, np.float32), 0, 1)
    gt = np.clip(np.asarray(gt, np.float32), 0, 1)
    pred = composite_white(pred, alpha)
    gt = composite_white(gt, alpha)
    if gamma:
        pred = pred ** (1.0 / gamma)
        gt = gt ** (1.0 / gamma)
    return dict(
        psnr=psnr(pred, gt, device=device),
        ssim=ssim(pred, gt, device=device),
        lpips=lpips(pred, gt, device=device),
        mse=mse(pred, gt, device=device),
    )


def _mean_scores(agg):
    return {c: {k: float(np.mean(v)) for k, v in scores.items()} for c, scores in agg.items()}


def evaluate_outputs(output_dir: str, dataset, image_size, components=("rgb",), gamma_shading: float = 2.2,
                     device=None) -> Dict[str, Dict[str, float]]:
    """Score the dumped ``{idx}_{key}_map.png`` renders against the
    dataset's targets. components: of ('rgb', 'ref', 'sha'); 'ref'/'sha'
    need the dataset's ground-truth intrinsics (``load_iid``)."""
    comp_key = {"rgb": ("rgb_map", "image", None),
                "ref": ("o_r_map", "Ref", None),
                "sha": ("o_s_map", "Sha", gamma_shading)}
    agg: Dict[str, Dict[str, list]] = {c: {} for c in components}
    for i in range(len(dataset)):
        sample = dataset.get_full_sample(i)
        idx = sample.get("idx", i)
        for comp in components:
            pred_key, gt_key, gamma = comp_key[comp]
            path = os.path.join(output_dir, f"{idx}_{pred_key}.png")
            if not os.path.exists(path) or gt_key not in sample:
                continue
            pred = load_image(path)[..., :3]
            gt = np.asarray(sample[gt_key])[..., :3]
            for k, v in calculate_metrics(pred, gt, gamma=gamma, device=device).items():
                if v is not None:
                    agg[comp].setdefault(k, []).append(v)
    return _mean_scores(agg)


# Output layouts: (method, component, index) -> file name, to score this
# framework's dumps and other methods' published outputs against the same
# ground truth.
METHOD_LAYOUTS = {
    # ours: {idx}_{o_r|o_s|rgb}_map.png (the image inference mode)
    "ours": lambda path, comp, i: os.path.join(
        path, f"{i}_{ {'Ref': 'o_r', 'Sha': 'o_s', 'Img': 'rgb'}[comp] }_map.png"
    ),
    "IntrinsicNeRF": lambda path, comp, i: os.path.join(
        path, f"{ {'Ref': 'a', 'Sha': 's', 'Img': ''}[comp] }{i:03d}.png"
    ),
    "NRHints": lambda path, comp, i: os.path.join(path, f"rgb_{i:03d}.png"),
    "PIE-Net": lambda path, comp, i: os.path.join(
        path, f"{i:03d}_{ {'Ref': 'ref', 'Sha': 'sha'}[comp] }.png"
    ),
    "InvRender": lambda path, comp, i: os.path.join(
        path, f"{ {'Ref': 'albedo', 'Img': 'sg_rgb_bg'}[comp] }_{i}.png"
    ),
    "TensoIR": lambda path, comp, i: os.path.join(
        path,
        (f"imgs_test_all/brdf/{i:03d}_albedo.png" if comp == "Ref"
         else f"imgs_test_all/nvs_with_radiance_field/{i:03d}_rgb_prediction.png"),
    ),
}


def evaluate_method_outputs(pred_dir: str, gt_dir: str, method: str = "ours", components=("Img",),
                            num_images: int = 100, gamma_shading: float = 2.2, device=None):
    """Score a method's dumped images against ground-truth dumps laid out
    as ``{i:03d}_{Img|Ref|Sha}.png``; the Img alpha channel is the
    compositing matte."""
    layout = METHOD_LAYOUTS[method]
    agg: Dict[str, Dict[str, list]] = {c: {} for c in components}
    for i in range(num_images):
        gt_img_path = os.path.join(gt_dir, f"{i:03d}_Img.png")
        if not os.path.exists(gt_img_path):
            continue
        gt_rgba = load_image(gt_img_path)
        alpha = gt_rgba[..., 3:4] if gt_rgba.shape[-1] == 4 else None
        for comp in components:
            pred_path = layout(pred_dir, comp, i)
            gt_path = os.path.join(gt_dir, f"{i:03d}_{comp}.png")
            if not (os.path.exists(pred_path) and os.path.exists(gt_path)):
                continue
            pred = load_image(pred_path)[..., :3]
            gt = load_image(gt_path)[..., :3]
            gamma = gamma_shading if comp == "Sha" else None
            for k, v in calculate_metrics(pred, gt, alpha=alpha, gamma=gamma, device=device).items():
                if v is not None:
                    agg[comp].setdefault(k, []).append(v)
    return _mean_scores(agg)


def main(argv=None):
    """``python -m mlinerf_tpu_torch.pipelines.metrics --config <yaml>
    --output_dir <dir> [--components rgb,ref,sha] [--allow_missing_lpips]
    [--device cuda|cpu] [--a.b=value ...]``: scores the image inference
    mode's dump against the validation split; returns the scores."""
    import argparse

    parser = argparse.ArgumentParser(description="compute metrics (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--components", default="rgb")
    parser.add_argument(
        "--allow_missing_lpips", action="store_true",
        help="proceed without LPIPS when assets/lpips_alex.npz is absent "
             "(default: error; the reference always scores LPIPS)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args, cfg_cmd = parser.parse_known_args(argv)
    if lpips_weights_path() is None and not args.allow_missing_lpips:
        raise SystemExit(
            "[metrics] ERROR: LPIPS weights not found (assets/lpips_alex.npz "
            "or $LPIPS_WEIGHTS). The reference's metrics always include "
            "LPIPS-AlexNet; refusing to emit a silently incomplete table.\n"
            "  Export once on any torch+lpips host:\n"
            "    python scripts/export_lpips_weights.py --out assets/lpips_alex.npz\n"
            "  or pass --allow_missing_lpips to score PSNR/SSIM/MSE only."
        )
    device = get_device(args.device)
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(args.config, cli_args=cfg_cmd)
    for split in ("train", "val"):
        if "load_iid" in cfg.data.get(split, {}):
            cfg.data[split].load_iid = True
    ds = resolve("dataset", cfg.data.type)(cfg, is_inference=True)
    results = evaluate_outputs(args.output_dir, ds, cfg.data.val.image_size,
                               components=args.components.split(","), device=device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
