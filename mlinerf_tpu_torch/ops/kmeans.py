"""Batched k-means (Lloyd's algorithm) over independent point sets.

The pseudo-label pipeline clusters each pixel's colours under L lights: P
independent problems of L points each, held as one [P, L, D] tensor, so
every step is one batched tensor operation with no per-pixel loop.

Seeding is greedy farthest-point: the first centre is a given point of
each set, each further centre the point farthest from the centres so far.
Then a fixed number of Lloyd iterations with the expanded distance
``|x|^2 - 2 x.c + |c|^2``; a cluster left empty keeps its centre. Ties in
``argmin``/``argmax`` take the first index, as XLA's do.

The JAX package draws each set's first point with ``jax.random``, which
torch cannot reproduce, so the first points are an argument here
(``first_index``); without it they are drawn from a CPU ``torch.Generator``
seeded with 0, which gives the same draws on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlinerf_tpu_torch.utils.misc import no_tf32


def first_indices(num_sets: int, num_points: int, device=None) -> torch.Tensor:
    """[num_sets] int64 indices in [0, num_points), drawn on the CPU from seed 0."""
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, num_points, (num_sets,), generator=gen).to(device)


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[P, N, K] squared distances, as a sum of squared differences."""
    return torch.sum((points[:, :, None, :] - centers[:, None, :, :]) ** 2, dim=-1)


def kmeans(points: torch.Tensor, num_clusters: int, num_iters: int = 25,
           first_index: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster each of P point sets [P, N, D] into K clusters.

    Returns (labels [P, N] int32, centers [P, K, D])."""
    P, N, D = points.shape
    K = num_clusters
    if first_index is None:
        first_index = first_indices(P, N, device=points.device)
    rows = torch.arange(P, device=points.device)
    centers = points.new_zeros(P, K, D)
    centers[:, 0] = points[rows, first_index.to(points.device).long()]
    for i in range(1, K):
        d2 = torch.amin(_sq_dists(points, centers[:, :i]), dim=-1)  # [P, N]
        centers[:, i] = points[rows, torch.argmax(d2, dim=-1)]

    x_sq = torch.sum(points ** 2, dim=-1, keepdim=True)  # [P, N, 1]
    with no_tf32():
        for _ in range(num_iters):
            d2 = (x_sq - 2 * torch.bmm(points, centers.transpose(1, 2))
                  + torch.sum(centers ** 2, dim=-1)[:, None, :])
            one_hot = torch.nn.functional.one_hot(torch.argmin(d2, dim=-1), K).to(points.dtype)  # [P, N, K]
            sums = torch.bmm(one_hot.transpose(1, 2), points)  # [P, K, D]
            counts = torch.sum(one_hot, dim=1)[..., None]  # [P, K, 1]
            centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1), centers)
    labels = torch.argmin(_sq_dists(points, centers), dim=-1).to(torch.int32)
    return labels, centers


def kmeans_per_pixel(vectors: torch.Tensor, num_clusters: int, num_iters: int = 25,
                     first_index: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster per-pixel multi-light vectors [P, L, D]: labels [P, L] int32,
    centers [P, K, D]. One cluster needs no iterations: every label is 0 and
    the centre is the mean."""
    if num_clusters == 1:
        P, L, _ = vectors.shape
        labels = torch.zeros(P, L, dtype=torch.int32, device=vectors.device)
        return labels, torch.mean(vectors, dim=1, keepdim=True)
    return kmeans(vectors, num_clusters, num_iters, first_index=first_index)
