"""Volume-rendering compositing: NeRF quadrature weights from densities
and front-to-back alpha compositing. Transmittance accumulates in float32."""

from __future__ import annotations

import torch


def _sigma_delta(densities, dists, dist_far):
    """densities [...,N] times the intervals of dists [...,N,1], the last
    one reaching ``dist_far`` [...,1,1] (default 1e10)."""
    if dist_far is None:
        dist_far = torch.full_like(dists[..., :1, :], 1e10)
    dists = torch.cat([dists, dist_far], dim=-2)  # [...,N+1,1]
    return densities * (dists[..., 1:, 0] - dists[..., :-1, 0])


def volume_rendering_weights_dist(densities, dists, dist_far=None):
    """NeRF quadrature weights [...,N,1] from densities [...,N] at distances
    [...,N,1]: alpha_i = 1 - exp(-sigma_i delta_i), transmittance the exp
    of the exclusive cumulative sum, both in float32."""
    sigma_delta = _sigma_delta(densities, dists, dist_far).float()
    sigma_delta_0 = torch.cat([torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]], dim=-1)
    T = torch.exp(-torch.cumsum(sigma_delta_0, dim=-1))
    alphas = 1 - torch.exp(-sigma_delta)
    return (T * alphas)[..., None]


def volume_rendering_alphas_dist(densities, dists, dist_far=None):
    """Per-sample opacities [...,N] from densities (alphas only, no weights)."""
    return 1 - torch.exp(-_sigma_delta(densities, dists, dist_far))


def _reversed_cumsum(w):
    return w.flip(-1).cumsum(-1).flip(-1)


class _CumProd(torch.autograd.Function):
    """``torch.cumprod`` along the last axis, with PyTorch's backward
    computed without its host check: PyTorch reads ``(x == 0).any()`` on the
    host to take the division form, which waits for the device and so
    cannot run in a captured step. Here both forms run and ``where`` picks:
    before a slice's first zero, ``reversed_cumsum(y * g) / x`` (PyTorch's
    form, the same bits); at the first zero, ``reversed_cumsum(y' * g)``
    with that zero replaced by 1 in ``y'``; after it, 0."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        is_zero = x == 0
        zeros = torch.cumsum(is_zero.to(torch.int32), dim=-1)  # zeros up to and including each entry
        first = is_zero & (zeros == 1)
        at_first = _reversed_cumsum(torch.cumprod(torch.where(first, torch.ones_like(x), x), dim=-1) * g)
        return torch.where(zeros == 0, _reversed_cumsum(y * g) / x,
                           torch.where(first, at_first, torch.zeros_like(x)))


def alpha_compositing_weights(alphas):
    """Front-to-back compositing: w_i = a_i * prod_{j<i}(1-a_j).
    [...,N] -> [...,N,1]."""
    alphas32 = alphas.float()
    alphas_front = torch.cat([torch.zeros_like(alphas32[..., :1]), alphas32[..., :-1]], dim=-1)
    visibility = _CumProd.apply(1 - alphas_front)
    return (alphas32 * visibility)[..., None]


def composite(quantities, weights):
    """Weighted sum over the samples axis: [...,N,K],[...,N,1] -> [...,K]."""
    return torch.sum(quantities * weights, dim=-2)


def composite_opacity(weights):
    """Total rendered opacity: [...,N,1] -> [...,1]."""
    return torch.sum(weights, dim=-2)
