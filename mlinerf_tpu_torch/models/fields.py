"""Neural fields: the hash-grid or Fourier SDF, numerical SDF gradients,
the Neuralangelo radiance head (NeuralRGB), the inverse-sphere background
NeRF (BackgroundNeRF, optionally light-conditioned) and the light-conditioned
radiance head bank (LumenRGB, every network mode).

Parameter layout follows the JAX package (``hash_table`` per level, ``mlp``,
``mlp_feat``/``mlp_rgb``) so ``bridge.params_from_jax`` carries weights
across.

Mixed precision (``compute_dtype``, bf16 under ``trainer.amp_config``) is
cast where the JAX package casts: the SDF's encoding joins the points in
float32 and the MLP computes in bf16, its SDF head back in float32 and its
feature left in bf16; every radiance head casts its inputs to bf16 and
takes its sigmoid (and the background its density) in float32. The
parameters stay float32.
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


@functools.lru_cache(maxsize=None)
def _band_mask(level_mask, device: torch.device) -> torch.Tensor:
    """The Fourier band mask on ``device``, copied there once per mask."""
    return torch.from_numpy(np.repeat(np.asarray(level_mask, np.float32), 6)).to(device)


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
    """SDF with a feature output on a hash-grid encoding or, with
    ``encoding.type: fourier``, on the points' positional encoding
    (``6 * levels`` dims, no table)."""

    def __init__(self, cfg_sdf, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoding_type = cfg_sdf.encoding.type
        if self.encoding_type == "hashgrid":
            self.spec = make_hashgrid_spec(cfg_sdf.encoding)
            self.dense_blocked = bool(cfg_sdf.encoding.hashgrid.get("dense_blocked", False))
            cs = cfg_sdf.gradient.get("corner_sample") or {}
            self.corner_opts = dict(floor=float(cs.get("floor", 0.125)), k=int(cs.get("corners", 1)),
                                    mode=str(cs.get("mode", "cotangent")),
                                    exact_finest=int(cs.get("exact_finest", 0)))
            self.hash_table = nn.ParameterList(
                [nn.Parameter(t) for t in hashgrid.init_tables(self.spec, generator)])
            encoding_dim = self.spec.output_dim
        elif self.encoding_type == "fourier":
            self.fourier_levels = cfg_sdf.encoding.levels
            encoding_dim = 6 * self.fourier_levels
        else:
            raise NotImplementedError(f"model.object.sdf.encoding.type '{self.encoding_type}'")
        cfg_mlp = cfg_sdf.mlp
        layer_dims = [3 + encoding_dim] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers + [cfg_mlp.hidden_dim]
        self.mlp = MLPforNeuralSDF(
            layer_dims, generator,
            skip_connection=cfg_mlp.skip,
            activ=get_activation(cfg_mlp.activ, **dict(cfg_mlp.get("activ_params", {}) or {})),
            use_weightnorm=cfg_mlp.weight_norm,
            geometric_init=cfg_mlp.geometric_init,
            out_bias=cfg_mlp.out_bias,
            invert=cfg_mlp.get("inside_out", False),
            compute_dtype=compute_dtype,
        )

    def _corner(self, corner_draw):
        """The corner sampling of the table gradient, with uniforms from
        ``corner_draw`` (None: the exact gradient)."""
        return None if corner_draw is None else hashgrid.CornerSampling(corner_draw, **self.corner_opts)

    def encode(self, points, level_mask=None, max_levels=None, corner_draw=None):
        if self.encoding_type == "fourier":
            feats = enc.positional_encoding(points, self.fourier_levels)
            if level_mask is not None:
                # The JAX package's band mask: each level's entry repeated 6
                # times over the (dim, sin/cos, level) layout.
                feats = feats * _band_mask(tuple(float(m) for m in level_mask), feats.device)
            return torch.cat([points, feats], dim=-1)
        feats = hashgrid.encode(list(self.hash_table), points, self.spec, level_mask=level_mask,
                                max_levels=max_levels, dense_blocked=self.dense_blocked,
                                corner=self._corner(corner_draw))
        return torch.cat([points, feats.to(points.dtype)], dim=-1)

    def forward(self, points, level_mask=None, with_sdf=True, with_feat=True, max_levels=None, corner_draw=None):
        return self.mlp(self.encode(points, level_mask=level_mask, max_levels=max_levels, corner_draw=corner_draw),
                        with_sdf=with_sdf, with_feat=with_feat)

    def stencil(self, points, offsets, level_mask=None, shared_levels=0, max_levels=None, corner_draw=None):
        """The SDF and feature at the points and the SDF at their taps
        (``points[..., None, :] + offsets``) in one encoder pass, the
        coarse ``shared_levels`` levels shared (``hashgrid.encode_stencil``).
        Returns (sdf_center [..., 1], feat_center [..., W], sdf_taps [..., T])."""
        feats = hashgrid.encode_stencil(list(self.hash_table), points, offsets, self.spec, level_mask=level_mask,
                                        shared_levels=shared_levels, max_levels=max_levels,
                                        dense_blocked=self.dense_blocked, corner=self._corner(corner_draw))
        offs_all = torch.cat([offsets.new_zeros(1, 3), offsets.float()])
        pts_all = points[..., None, :] + offs_all  # [..., 1+T, 3]
        enc_all = torch.cat([pts_all, feats.to(pts_all.dtype)], dim=-1)
        sdf_center, feat_center = self.mlp(enc_all[..., 0, :], with_sdf=True, with_feat=True)
        sdf_taps, _ = self.mlp(enc_all[..., 1:, :], with_sdf=True, with_feat=False)
        return sdf_center, feat_center, sdf_taps[..., 0]


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


def view_encoder(cfg_view):
    """(dims, function) of a direction encoding: ``fourier`` (the
    positional encoding, 6 * levels dims) or ``spherical`` (real SH,
    (levels + 1)^2 dims)."""
    levels = cfg_view.levels
    if cfg_view.type == "fourier":
        return 6 * levels, functools.partial(enc.positional_encoding, num_freq_bases=levels)
    if cfg_view.type == "spherical":
        return (levels + 1) ** 2, functools.partial(enc.spherical_harmonics, levels=levels)
    raise NotImplementedError(f"view encoding type '{cfg_view.type}'")


def _activation(cfg_mlp, key="activ"):
    return get_activation(cfg_mlp[key], **dict(cfg_mlp.get(f"{key}_params", {}) or {}))


def _appear_dim(appear_embed) -> int:
    return appear_embed.dim if appear_embed is not None and appear_embed.enabled else 0


class NeuralRGB(nn.Module):
    """Neuralangelo's view-dependent radiance head: one MLP on points (p),
    view encoding (v), normals (n), SDF features (f) and the appearance
    embedding where given, squashed by a sigmoid in float32. Input modes
    (``model.object.rgb.mode``): ``idr`` [p, v, n, f], ``no_view_dir``
    [p, n, f], ``no_normal`` [p, v, f]."""

    def __init__(self, cfg_rgb, feat_dim: int, appear_embed, generator: torch.Generator,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg_mlp = cfg_rgb.mlp
        self.compute_dtype = compute_dtype
        self.mode = cfg_rgb.mode
        view_dim, self.encode_view = view_encoder(cfg_rgb.encoding_view)
        dropped = {"idr": 0, "no_view_dir": view_dim, "no_normal": 3}
        if self.mode not in dropped:
            raise NotImplementedError(f"model.object.rgb.mode '{self.mode}'")
        input_dim = 3 + view_dim + 3 + feat_dim + _appear_dim(appear_embed) - dropped[self.mode]
        self.mlp = MLPwithSkipConnection(
            [input_dim] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers + [3], generator,
            skip_connection=cfg_mlp.skip, activ=_activation(cfg_mlp), use_weightnorm=cfg_mlp.weight_norm,
            compute_dtype=compute_dtype)

    def forward(self, points, normals, rays_unit, feats, app=None):
        inputs = {"idr": [points, self.encode_view(rays_unit), normals, feats],
                  "no_view_dir": [points, normals, feats],
                  "no_normal": [points, self.encode_view(rays_unit), feats]}[self.mode]
        if app is not None:
            inputs.append(app)
        x = torch.cat([i.to(self.compute_dtype) for i in inputs], dim=-1)
        return torch.sigmoid(self.mlp(x).float())


class BackgroundNeRF(nn.Module):
    """Inverse-sphere background NeRF: each point becomes [p/|p|, 1/|p|]
    and that with its positional encoding (4 + 8 * levels dims) goes
    through ``mlp_feat``, whose first output is the density (through
    ``activ_density``) and the rest a feature (through ``activ``). The
    feature, the view encoding, with ``with_light`` the light position's
    view encoding (the Lumen model's background) and the appearance
    embedding where given go through ``mlp_rgb`` to a sigmoid rgb.
    Returns (rgb [...,3], density [...]) in float32."""

    def __init__(self, cfg_background, appear_embed, generator: torch.Generator, with_light: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg_mlp = cfg_background.mlp
        self.compute_dtype = compute_dtype
        self.levels = cfg_background.encoding.levels
        self.with_light = with_light
        view_dim, self.encode_view = view_encoder(cfg_background.encoding_view)
        input_view_dim = cfg_mlp.hidden_dim + view_dim * (2 if with_light else 1) + _appear_dim(appear_embed)
        self.activ = _activation(cfg_mlp)
        self.activ_density = _activation(cfg_mlp, "activ_density")
        self.mlp_feat = MLPwithSkipConnection(
            [4 + 8 * self.levels] + [cfg_mlp.hidden_dim] * (cfg_mlp.num_layers - 1) + [cfg_mlp.hidden_dim + 1],
            generator, skip_connection=cfg_mlp.skip, activ=self.activ, compute_dtype=compute_dtype)
        self.mlp_rgb = MLPwithSkipConnection(
            [input_view_dim] + [cfg_mlp.hidden_dim_rgb] * (cfg_mlp.num_layers_rgb - 1) + [3], generator,
            skip_connection=cfg_mlp.skip_rgb, activ=self.activ, compute_dtype=compute_dtype)

    def encode(self, points):
        norm = torch.linalg.norm(points, dim=-1, keepdim=True)
        points = torch.cat([points / norm, 1.0 / norm], dim=-1)  # [...,4]
        return torch.cat([points, enc.positional_encoding(points, self.levels)], dim=-1)

    def forward(self, points, rays_unit, pts_light=None, app_outside=None):
        dt = self.compute_dtype
        out = self.mlp_feat(self.encode(points).to(dt))
        density = self.activ_density(out[..., 0].float())
        inputs = [self.activ(out[..., 1:]), self.encode_view(rays_unit).to(dt)]
        if self.with_light:
            inputs.append(self.encode_view(pts_light).to(dt))
        if app_outside is not None:
            inputs.append(app_outside.to(dt))
        rgb = torch.sigmoid(self.mlp_rgb(torch.cat(inputs, dim=-1)).float())
        return rgb, density


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
    head warm-starts a stage-b bank. With appearance embeddings on, every
    head also reads the embedding (``app``), last. Returns the mode's
    outputs by name: ``rgb``, ``o_r``, ``o_s``, ``o_re``."""

    def __init__(self, cfg_rgb, feat_dim: int, generator: torch.Generator, appear_embed=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg_mlp = cfg_rgb.mlp
        self.compute_dtype = compute_dtype
        self.network_mode = cfg_rgb.get("network_mode") or "rgb"
        self.input_mode = cfg_rgb.get("mode")
        view_dim, self.encode_view = view_encoder(cfg_rgb.encoding_view)
        p, v, n, f, l = 3, view_dim, 3, feat_dim, view_dim
        app_dim = _appear_dim(appear_embed)

        def head(in_dim, out_dim):
            return MLPwithSkipConnection(
                [in_dim + app_dim] + [cfg_mlp.hidden_dim] * cfg_mlp.num_layers + [out_dim], generator,
                skip_connection=cfg_mlp.skip, activ=_activation(cfg_mlp), use_weightnorm=cfg_mlp.weight_norm,
                compute_dtype=compute_dtype)

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

    def forward(self, points, normals, rays_unit, feats, pts_light, app=None):
        dt = self.compute_dtype
        p, n, f = points.to(dt), normals.to(dt), feats.to(dt)
        v = self.encode_view(rays_unit).to(dt)
        l = self.encode_view(pts_light).to(dt)
        extra = [] if app is None else [app.to(dt)]

        def cat(parts):
            return torch.cat(parts + extra, -1)

        def sig(x):
            return torch.sigmoid(x.float())

        mode = self.network_mode
        if mode == "r_s":
            return {"o_r": sig(self.mlp_r(cat([p, n, f]))),
                    "o_s": self.mlp_s(cat([p, v, n, f, l])).float()}
        if mode == "r_s_re":
            return {"o_r": sig(self.mlp_r(cat([p, n, f]))),
                    "o_s": sig(self.mlp_s(cat([p, n, f, l]))),
                    "o_re": sig(self.mlp_re(cat([p, v, n, f, l])))}
        rgb_inputs = {"no_view_dir": [p, n, f, l], "no_normal": [p, v, f, l]}.get(
            self.input_mode if mode == "rgb" else None, [p, v, n, f, l])
        out = {"rgb": sig(self.mlp(cat(rgb_inputs)))}
        if mode in ("rgb_r", "rgb_r_s"):
            out["o_r"] = sig(self.mlp_r(cat([p, n, f])))
        if mode == "rgb_r_s":
            out["o_s"] = sig(self.mlp_s(cat([p, n, f, l])))
        return out
