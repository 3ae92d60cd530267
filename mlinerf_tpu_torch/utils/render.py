"""Volume-rendering compositing. Transmittance accumulates in float32."""

from __future__ import annotations

import torch


def alpha_compositing_weights(alphas):
    """Front-to-back compositing: w_i = a_i * prod_{j<i}(1-a_j).
    [...,N] -> [...,N,1]."""
    alphas32 = alphas.float()
    alphas_front = torch.cat([torch.zeros_like(alphas32[..., :1]), alphas32[..., :-1]], dim=-1)
    visibility = torch.cumprod(1 - alphas_front, dim=-1)
    return (alphas32 * visibility)[..., None]


def composite(quantities, weights):
    """Weighted sum over the samples axis: [...,N,K],[...,N,1] -> [...,K]."""
    return torch.sum(quantities * weights, dim=-2)


def composite_opacity(weights):
    """Total rendered opacity: [...,N,1] -> [...,1]."""
    return torch.sum(weights, dim=-2)
