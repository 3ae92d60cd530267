"""Losses: L1 render loss, PSNR, the eikonal and curvature regularizers,
and the stage-b intrinsic, weighted-shading and residual losses."""

from __future__ import annotations

import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def psnr(pred, target, eps=1e-12):
    return -10.0 * torch.log10(mse_loss(pred, target) + eps)


def _nan_to_num(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    """L2 norm with ``eps`` inside the square root, so the gradient at
    x == 0 is zero rather than NaN (SDF gradients are exactly zero in
    constant regions)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def safe_normalize(x, dim=-1, eps=1e-12):
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)


def eikonal_loss(gradients, outside=None):
    """(||grad sdf|| - 1)^2, masked to rays inside the bounding volume."""
    err = _nan_to_num((safe_norm(gradients, dim=-1) - 1.0) ** 2)  # [B,R,N]
    if outside is not None:
        # The [B,R,1] mask broadcasts over the samples axis.
        return torch.mean(err * (~outside).to(err.dtype))
    return torch.mean(err)


def curvature_loss(hessian, outside=None):
    """|trace of the (diagonal) hessian| — Laplacian magnitude regularizer."""
    lap = _nan_to_num(torch.abs(torch.sum(hessian, dim=-1)))  # [B,R,N]
    if outside is not None:
        return torch.mean(lap * (~outside).to(lap.dtype))
    return torch.mean(lap)


# ---------------------------------------------------------------------------
# Stage b: pseudo-label supervision of the intrinsic heads
# ---------------------------------------------------------------------------


def weighted_shading_loss(predicted_shading, pseudo_shading, weight_range=(0.0, 1.0)):
    """L1 on shading, weighted by (pseudo / 0.5)^2 clipped to [0, 1] and
    mapped onto ``weight_range``; the weight carries no gradient."""
    weight = torch.clamp(pseudo_shading / 0.5, 0.0, 1.0)
    weight = (weight ** 2 * (weight_range[1] - weight_range[0]) + weight_range[0]).detach()
    abs_diff = torch.abs(predicted_shading - pseudo_shading)
    return torch.mean(abs_diff * weight) / (torch.mean(weight) + 1e-6)


def _normalize_range(x, lo, hi):
    x_min, x_max = torch.min(x), torch.max(x)
    return lo + (x - x_min) / torch.clamp(x_max - x_min, min=1e-6) * (hi - lo)


def intrinsic_loss(output_ref, output_sha, pseudo_ref, pseudo_sha, pseudo_visibility_certainty,
                   weight_map_range_shading=(0.25, 1.0), weight_map_range_visibility=(0.25, 1.0),
                   factor_ref: float = 1.0, factor_sha: float = 1.0):
    """Weighted L1 of reflectance and shading against their pseudo labels.
    The shading weight is the pseudo shading rescaled to its range; the
    reflectance weight is the smaller of that and the rescaled visibility
    certainty. Neither weight carries a gradient."""
    weight_map_sha = _normalize_range(pseudo_sha.detach(), *weight_map_range_shading)
    weight_map_vis = _normalize_range(pseudo_visibility_certainty.detach(), *weight_map_range_visibility)
    weight_map_ref = torch.minimum(weight_map_vis, weight_map_sha)
    distance_l1_ref = torch.mean(torch.abs(output_ref - pseudo_ref) * weight_map_ref)
    distance_l1_sha = torch.mean(torch.abs(output_sha - pseudo_sha) * weight_map_sha)
    return distance_l1_ref * factor_ref + distance_l1_sha * factor_sha


def regularize_re_loss(output_re, factor_negative=10.0, factor_positive=1.0, exponent_positive=1.0):
    """A heavy penalty on negative residual, a light one on its positive part."""
    zero = torch.zeros_like(output_re)
    reg_negative = torch.mean(torch.abs(torch.where(output_re < 0.0, output_re, zero)))
    reg_positive = torch.mean(torch.where(output_re >= 0.0, output_re, zero) ** exponent_positive)
    return reg_negative * factor_negative + reg_positive * factor_positive
