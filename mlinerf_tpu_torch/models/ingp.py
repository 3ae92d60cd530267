"""Instant-NGP: the NeRF renderer with a multiresolution hash-grid encoding
of the point (``points ‖ encode(points)``) in place of the positional one.

Each level's table is a parameter (``hash_table.<level>``, the JAX
package's per-level tuple) and its gradient goes through
``hashgrid_scatter.take_rows``, so on the card every level's backward
launches ``csrc/scatter_add_rows.cu``. The tables are float32, as in the
JAX package, whose ``INGPField`` builds its spec without the config's
``hashgrid.dtype``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.models import nerf
from mlinerf_tpu_torch.ops import hashgrid


def make_spec(cfg_hashgrid) -> hashgrid.HashGridSpec:
    """The encoding's spec, with the JAX package's defaults; float32 tables
    whatever ``dtype`` says."""
    hg = cfg_hashgrid
    rng = hg.get("range", [-1, 1])
    return hashgrid.HashGridSpec(
        num_levels=hg.get("levels", 16),
        features_per_level=hg.get("dim", 2),
        log2_hashmap_size=hg.get("dict_size", 19),
        min_logres=hg.get("min_logres", 4),
        max_logres=hg.get("max_logres", 11),
        range_min=float(rng[0]),
        range_max=float(rng[1]),
    )


class INGPField(nerf.NeRFField):
    """NeRF field whose 3D input is the point and its hash-grid features."""

    def __init__(self, cfg_model, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        spec = make_spec(cfg_model.posenc.hashgrid)
        super().__init__(cfg_model, generator, compute_dtype, input_3D_dim=3 + spec.output_dim)
        self.spec = spec
        self.hash_table = nn.ParameterList([nn.Parameter(t) for t in hashgrid.init_tables(spec, generator)])

    def encode_3D(self, points):
        feats = hashgrid.encode(list(self.hash_table), points, self.spec)
        return torch.cat([points, feats.to(points.dtype)], dim=-1)


@register("model", "ingp")
class Model(nerf.Model):
    """The Instant-NGP renderer (hash-encoded NeRF)."""

    field_cls = INGPField
