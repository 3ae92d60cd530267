"""Stage-a losses: L1 render loss, PSNR, eikonal and curvature regularizers."""

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
