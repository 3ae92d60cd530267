"""Brute-force nearest neighbours in feature space, for the pseudo-label
hole fill.

Every pixel is a query and every pixel a database row; invalid rows get a
large distance penalty instead of being removed, so the shapes do not
depend on the mask. Queries go in chunks of 2048: one [2048, P] distance
block at a time (512 MB in float32 at 256 x 256 pixels), never the P x P
matrix. Distances use the expanded form ``|q|^2 - 2 q.f + |f|^2`` with a
float32 product (TF32 off); ties take the first index.
"""

from __future__ import annotations

import torch

from mlinerf_tpu_torch.utils.misc import no_tf32

CHUNK = 2048


def nearest_neighbor(queries: torch.Tensor, database: torch.Tensor, chunk: int = 4096):
    """For each query row [Q, D], the index of its nearest database row
    [N, D] (int32) and the squared distance to it."""
    db_sq = torch.sum(database ** 2, dim=-1)
    idx, dist = [], []
    with no_tf32():
        for q in torch.split(queries, chunk):
            d2 = torch.sum(q ** 2, dim=-1, keepdim=True) - 2 * (q @ database.T) + db_sq[None, :]
            d_min, i_min = torch.min(d2, dim=-1)
            idx.append(i_min.to(torch.int32))
            dist.append(d_min)
    return torch.cat(idx), torch.cat(dist)


def masked_nearest_indices(features: torch.Tensor, valid_mask: torch.Tensor,
                           fill_weight: float = 1e6) -> torch.Tensor:
    """For each pixel of ``features`` [P, D], the index [P] of the nearest
    pixel whose ``valid_mask`` [P] is True (invalid rows are ``fill_weight``
    farther away)."""
    db_sq = torch.sum(features ** 2, dim=-1)
    penalty = torch.where(valid_mask, 0.0, fill_weight).to(features.dtype)
    picks = []
    with no_tf32():
        for q in torch.split(features, CHUNK):
            d2 = (torch.sum(q ** 2, dim=-1, keepdim=True) - 2 * (q @ features.T)
                  + db_sq[None, :] + penalty[None, :])
            picks.append(torch.argmin(d2, dim=-1))
    return torch.cat(picks)


def masked_nearest_fill(values: torch.Tensor, features: torch.Tensor, valid_mask: torch.Tensor,
                        fill_weight: float = 1e6) -> torch.Tensor:
    """Replace ``values`` [P, C] at invalid pixels (``valid_mask`` [P] False)
    with the value of the nearest valid pixel in ``features`` [P, D]."""
    nearest = values.index_select(0, masked_nearest_indices(features, valid_mask, fill_weight))
    return torch.where(valid_mask[:, None], values, nearest)
