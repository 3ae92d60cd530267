"""Neural fields: the hash-grid SDF, numerical SDF gradients, and the
light-conditioned radiance head bank (LumenRGB, every network mode).

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
    """Light-conditioned radiance head bank. The inputs are points (p),
    view SH (v), normals (n), SDF features (f) and light-position SH (l):
    the light position is encoded with the view encoder, as in the
    reference. Network modes (``model.object.rgb.network_mode``):

      rgb (unset)  one head ``mlp`` on [p, v, n, f, l] -> rgb; the
                   ``no_view_dir`` / ``no_normal`` input modes drop v / n;
      r_s          ``mlp_r`` on [p, n, f] -> reflectance, ``mlp_s`` on
                   [p, v, n, f, l] -> shading, not squashed;
      r_s_re       ``mlp_r`` [p, n, f], ``mlp_s`` [p, n, f, l] and the
                   residual ``mlp_re`` [p, v, n, f, l];
      rgb_r        ``mlp`` -> rgb and ``mlp_r`` -> reflectance;
      rgb_r_s      ``mlp``, ``mlp_r`` and ``mlp_s`` [p, n, f, l] ->
                   ``shading_dim`` channels (default 3).

    ``mlp`` has the same inputs in every mode that has it, so a stage-a
    head warm-starts a stage-b bank. Returns the mode's outputs by name:
    ``rgb``, ``o_r``, ``o_s``, ``o_re``."""

    def __init__(self, cfg_rgb, feat_dim: int, generator: torch.Generator):
        super().__init__()
        cfg_mlp = cfg_rgb.mlp
        self.network_mode = cfg_rgb.get("network_mode") or "rgb"
        self.input_mode = cfg_rgb.get("mode")
        self.view_levels = cfg_rgb.encoding_view.levels
        p, v, n, f, l = 3, (self.view_levels + 1) ** 2, 3, feat_dim, (self.view_levels + 1) ** 2

        def head(in_dim, out_dim):
            return MLPwithSkipConnection(
                [in_dim] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers + [out_dim], generator,
                skip_connection=cfg_mlp.skip,
                activ=get_activation(cfg_mlp.activ, **dict(cfg_mlp.get("activ_params", {}) or {})),
                use_weightnorm=cfg_mlp.weight_norm,
            )

        mode = self.network_mode
        if mode == "r_s":
            self.mlp_r = head(p + n + f, 3)
            self.mlp_s = head(p + v + n + f + l, 3)
        elif mode == "r_s_re":
            self.mlp_r = head(p + n + f, 3)
            self.mlp_s = head(p + n + f + l, 3)
            self.mlp_re = head(p + v + n + f + l, 3)
        elif mode == "rgb_r":
            self.mlp = head(p + v + n + f + l, 3)
            self.mlp_r = head(p + n + f, 3)
        elif mode == "rgb_r_s":
            self.mlp = head(p + v + n + f + l, 3)
            self.mlp_r = head(p + n + f, 3)
            self.mlp_s = head(p + n + f + l, cfg_rgb.get("shading_dim", 3))
        elif mode == "rgb":
            dropped = {"no_view_dir": v, "no_normal": n}.get(self.input_mode, 0)
            self.mlp = head(p + v + n + f + l - dropped, 3)
        else:
            raise NotImplementedError(f"model.object.rgb.network_mode '{mode}'")

    def forward(self, points, normals, rays_unit, feats, pts_light):
        p, n, f = points, normals, feats
        v = enc.spherical_harmonics(rays_unit, self.view_levels)
        l = enc.spherical_harmonics(pts_light, self.view_levels)

        def sig(x):
            return torch.sigmoid(x.float())

        mode = self.network_mode
        if mode == "r_s":
            return {"o_r": sig(self.mlp_r(torch.cat([p, n, f], -1))),
                    "o_s": self.mlp_s(torch.cat([p, v, n, f, l], -1)).float()}
        if mode == "r_s_re":
            return {"o_r": sig(self.mlp_r(torch.cat([p, n, f], -1))),
                    "o_s": sig(self.mlp_s(torch.cat([p, n, f, l], -1))),
                    "o_re": sig(self.mlp_re(torch.cat([p, v, n, f, l], -1)))}
        rgb_inputs = {"no_view_dir": [p, n, f, l], "no_normal": [p, v, f, l]}.get(
            self.input_mode if mode == "rgb" else None, [p, v, n, f, l])
        out = {"rgb": sig(self.mlp(torch.cat(rgb_inputs, -1)))}
        if mode in ("rgb_r", "rgb_r_s"):
            out["o_r"] = sig(self.mlp_r(torch.cat([p, n, f], -1)))
        if mode == "rgb_r_s":
            out["o_s"] = sig(self.mlp_s(torch.cat([p, n, f, l], -1)))
        return out
