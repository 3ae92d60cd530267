"""Neural fields: the hash-grid SDF, numerical SDF gradients, and the
light-conditioned radiance head (plain ``rgb`` mode of the LumenRGB bank).

Parameter layout follows the JAX package (``hash_table`` per level, ``mlp``)
so ``bridge.params_from_jax`` carries weights across.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from mlinerf_tpu_torch.models.mlp import MLPforNeuralSDF, MLPwithSkipConnection
from mlinerf_tpu_torch.ops import hashgrid
from mlinerf_tpu_torch.utils import encoding as enc
from mlinerf_tpu_torch.utils.misc import get_activation

# Tetrahedral stencil of the 4-tap numerical gradient.
_TETRA = np.array([[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], np.float32)
_AXES = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)


@functools.lru_cache(maxsize=None)
def _stencil(taps: int, device: torch.device) -> torch.Tensor:
    """The tap directions on ``device``, copied there once."""
    return torch.from_numpy(_AXES if taps == 6 else _TETRA).to(device)


def make_hashgrid_spec(cfg_encoding) -> hashgrid.HashGridSpec:
    hg = cfg_encoding.hashgrid
    return hashgrid.HashGridSpec(
        num_levels=cfg_encoding.levels,
        features_per_level=hg.dim,
        log2_hashmap_size=hg.dict_size,
        min_logres=hg.min_logres,
        max_logres=hg.max_logres,
        range_min=float(hg.range[0]),
        range_max=float(hg.range[1]),
        dtype=hg.get("dtype", "float32"),
    )


class NeuralSDF(nn.Module):
    """Hash-grid encoded SDF with a feature output."""

    def __init__(self, cfg_sdf, generator: torch.Generator):
        super().__init__()
        self.spec = make_hashgrid_spec(cfg_sdf.encoding)
        self.hash_table = nn.ParameterList(
            [nn.Parameter(t) for t in hashgrid.init_tables(self.spec, generator)])
        cfg_mlp = cfg_sdf.mlp
        layer_dims = [3 + self.spec.output_dim] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers \
            + [cfg_mlp.hidden_dim]
        self.mlp = MLPforNeuralSDF(
            layer_dims, generator,
            skip_connection=cfg_mlp.skip,
            activ=get_activation(cfg_mlp.activ, **dict(cfg_mlp.get("activ_params", {}) or {})),
            use_weightnorm=cfg_mlp.weight_norm,
            geometric_init=cfg_mlp.geometric_init,
            out_bias=cfg_mlp.out_bias,
            invert=cfg_mlp.get("inside_out", False),
        )

    def encode(self, points, level_mask=None, max_levels=None):
        feats = hashgrid.encode(list(self.hash_table), points, self.spec,
                                level_mask=level_mask, max_levels=max_levels)
        return torch.cat([points, feats.to(points.dtype)], dim=-1)

    def forward(self, points, level_mask=None, with_sdf=True, with_feat=True, max_levels=None):
        return self.mlp(self.encode(points, level_mask=level_mask, max_levels=max_levels),
                        with_sdf=with_sdf, with_feat=with_feat)


def _tap_step(taps: int, eps):
    """Per-tap offset length: eps for 6 taps, eps/sqrt(3) for 4 (float32)."""
    if taps == 6:
        return np.float32(eps)
    if taps == 4:
        return np.float32(eps) / np.float32(np.sqrt(3))
    raise ValueError("Only 4 or 6 taps supported")


def numerical_gradient_taps(taps: int, eps, device=None) -> torch.Tensor:
    """Tap offsets [taps, 3]: 6 = central differences along +-x/+-y/+-z with
    step eps; 4 = tetrahedral stencil with step eps/sqrt(3)."""
    return _stencil(taps, torch.device(device or "cpu")) * float(_tap_step(taps, eps))


def numerical_gradients(sdf_tap_values, sdf_center, taps: int, eps, training: bool):
    """Gradient (and diagonal hessian when training) from tap SDF values.

    sdf_tap_values [..., taps]; sdf_center [..., 1]; eps the host-side step.
    Returns (gradient [...,3], hessian [...,3] or None).
    """
    s = sdf_tap_values
    h = _tap_step(taps, eps)
    hessian = None
    if taps == 6:
        gradient = torch.stack([(s[..., 0] - s[..., 1]) / float(2 * h),
                                (s[..., 2] - s[..., 3]) / float(2 * h),
                                (s[..., 4] - s[..., 5]) / float(2 * h)], dim=-1)
        if training:
            c = sdf_center[..., 0]
            hessian = torch.stack([(s[..., 0] + s[..., 1] - 2 * c) / float(h * h),
                                   (s[..., 2] + s[..., 3] - 2 * c) / float(h * h),
                                   (s[..., 4] + s[..., 5] - 2 * c) / float(h * h)], dim=-1)
        return gradient, hessian
    if taps == 4:
        gradient = (s @ _stencil(4, s.device)) / float(np.float32(4.0) * h)
        if training:
            c = sdf_center[..., 0]
            hxx = (torch.sum(s, dim=-1) / 2.0 - 2 * c) / float(h * h)
            hessian = torch.stack([hxx, hxx, hxx], dim=-1) / 3.0
        return gradient, hessian
    raise ValueError("Only 4 or 6 taps supported")


class LumenRGB(nn.Module):
    """Light-conditioned radiance head, plain ``rgb`` network mode with the
    ``idr`` inputs: one MLP on [points, view SH, normals, SDF features,
    light-position SH]. The light position is encoded with the view encoder
    (spherical harmonics), as in the reference."""

    def __init__(self, cfg_rgb, feat_dim: int, generator: torch.Generator):
        super().__init__()
        cfg_mlp = cfg_rgb.mlp
        self.view_levels = cfg_rgb.encoding_view.levels
        view_dim = (self.view_levels + 1) ** 2
        in_dim = 3 + view_dim + 3 + feat_dim + view_dim
        self.mlp = MLPwithSkipConnection(
            [in_dim] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers + [3], generator,
            skip_connection=cfg_mlp.skip,
            activ=get_activation(cfg_mlp.activ, **dict(cfg_mlp.get("activ_params", {}) or {})),
            use_weightnorm=cfg_mlp.weight_norm,
        )

    def forward(self, points, normals, rays_unit, feats, pts_light):
        view_enc = enc.spherical_harmonics(rays_unit, self.view_levels)
        light_enc = enc.spherical_harmonics(pts_light, self.view_levels)
        x = torch.cat([points, view_enc, normals, feats, light_enc], dim=-1)
        return torch.sigmoid(self.mlp(x).float())
