"""Ray sample distances: stratified or midpoint samples, hierarchical NeuS
importance resampling, and per-image ray picks.

Randomness comes from an explicit ``torch.Generator``. The generator's draws
differ from ``jax.random``'s, so parity with the JAX package is checked with
``stratified=False`` and injected ray indices.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlinerf_tpu_torch.utils import render


def sample_dists(ray_shape, dist_range, intvs: int, stratified: bool,
                 generator: Optional[torch.Generator] = None, device=None, rands=None):
    """``intvs`` distances per ray, jittered within each interval or at the
    midpoints. ``dist_range`` = (near, far), tensors broadcastable to
    [B,R,1,1] or floats. The jitter's uniforms come from ``generator``, or
    are ``rands`` [B,R,intvs,1] where given. Returns dists [B,R,intvs,1]."""
    dist_min, dist_max = dist_range
    shape = (*ray_shape, intvs, 1)
    if stratified and rands is not None:
        rands = rands.to(device=device, dtype=torch.float32)
    elif stratified:
        rands = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        rands = torch.full(shape, 0.5, device=device, dtype=torch.float32)
    rands = rands + torch.arange(intvs, dtype=torch.float32, device=device)[None, None, :, None]
    return rands / intvs * (dist_max - dist_min) + dist_min


def searchsorted_batched(sorted_seq, values):
    """Batched ``searchsorted(..., side='right')``: for each query the number
    of entries ``<=`` it. sorted_seq [...,N] ascending, values [...,M]."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(), right=True)


def sample_dists_from_pdf(bins, weights, intvs_fine: int, eps=1e-8):
    """Inverse-CDF sampling of fine distances from coarse weights.

    bins [...,N,1]; weights [...,N-1] unnormalized (the CDF spans the bin
    edges). Returns dists_fine [...,intvs_fine,1].
    """
    pdf = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=eps)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [...,N]
    grid = torch.linspace(0, 1, intvs_fine + 1, device=bins.device)
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(*cdf.shape[:-1], intvs_fine)
    idx = searchsorted_batched(cdf, unif)  # in {1..N}
    low = torch.clamp(idx - 1, min=0)
    high = torch.clamp(idx, max=cdf.shape[-1] - 1)
    bins_flat = bins[..., 0]
    last = bins_flat.shape[-1] - 1
    dist_min = torch.gather(bins_flat, -1, torch.clamp(low, max=last))
    dist_max = torch.gather(bins_flat, -1, torch.clamp(high, max=last))
    cdf_low = torch.gather(cdf, -1, low)
    cdf_high = torch.gather(cdf, -1, high)
    t = (unif - cdf_low) / (cdf_high - cdf_low + eps)
    return (dist_min + t * (dist_max - dist_min))[..., None]


def neus_pdf_weights(dists, sdfs, inv_s, robust: bool = True, eps=1e-5):
    """Section-wise NeuS weights for hierarchical resampling: linearized SDF
    per section, CDF-ratio alphas, robust min-with-previous slope.
    dists [...,N,1], sdfs [...,N] -> weights [...,N-1]."""
    prev_sdfs, next_sdfs = sdfs[..., :-1], sdfs[..., 1:]
    prev_dists, next_dists = dists[..., :-1, 0], dists[..., 1:, 0]
    mid_sdfs = 0.5 * (prev_sdfs + next_sdfs)
    cos_val = (next_sdfs - prev_sdfs) / (next_dists - prev_dists + 1e-5)
    if robust:
        prev_cos = torch.cat([torch.zeros_like(cos_val[..., :1]), cos_val[..., :-1]], dim=-1)
        cos_val = torch.minimum(prev_cos, cos_val)
    dist_intvs = next_dists - prev_dists
    est_prev = mid_sdfs - cos_val * dist_intvs * 0.5
    est_next = mid_sdfs + cos_val * dist_intvs * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alphas = torch.clamp((prev_cdf - next_cdf) / (prev_cdf + eps), 0.0, 1.0)
    return render.alpha_compositing_weights(alphas)[..., 0]


def random_ray_indices(generator: torch.Generator, batch_size: int, num_pixels: int,
                       num_rays: int, device=None):
    """``num_rays`` distinct pixel indices per batch element, [B,R] int64."""
    r = torch.rand(batch_size, num_pixels, generator=generator, device=device)
    return torch.argsort(r, dim=1)[:, :num_rays]


def slice_by_ray_idx(var, ray_idx):
    """Gather [B,HW,...] by per-batch ray indices [B,R] -> [B,R,...]."""
    idx = ray_idx.reshape(*ray_idx.shape, *([1] * (var.ndim - 2)))
    return torch.gather(var, 1, idx.expand(*ray_idx.shape, *var.shape[2:]))
