"""Binary morphology on images: erosion, dilation, their difference (the
edge band) and the multi-scale edge weight of the pseudo-label pipeline.

Layout: [..., H, W] float images with values in {0, 1}. Erosion is a min
over a k x k window with the image's edges replicated, written as
``-max_pool2d(-x)`` after a replicate pad; a min is exact, so the result
equals the JAX package's ``lax.reduce_window`` bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def erosion(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """1 where every pixel of the k x k window is 1 (edges replicated), else 0."""
    pad = kernel_size // 2
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    x4 = x.reshape(-1, 1, H, W)
    x_pad = F.pad(x4, (pad, pad, pad, pad), mode="replicate")
    out = -F.max_pool2d(-x_pad, kernel_size, stride=1)
    return torch.where(out >= 1.0, 1.0, 0.0).to(x.dtype).reshape(*lead, H, W)


def dilation(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    return 1.0 - erosion(1.0 - x, kernel_size)


def edge(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    return dilation(x, kernel_size) - erosion(x, kernel_size)


def edge_weight(x: torch.Tensor, step: int) -> torch.Tensor:
    """Certainty in [0, 1]: one minus the sum of the edge bands of widths
    3, 5, ..., 2 * step + 1, normalized by its maximum. Pixels near a
    visibility boundary get a low weight; an image with no edge keeps
    weight 1 everywhere."""
    weight = torch.zeros_like(x)
    for i in range(1, step + 1):
        weight = weight + edge(x, 2 * i + 1)
    m = torch.max(weight)
    weight = torch.where(m > 0.0, weight / torch.where(m > 0, m, torch.ones_like(m)), weight)
    return 1.0 - weight
