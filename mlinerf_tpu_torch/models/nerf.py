"""Vanilla NeRF: a positional-encoded density MLP with a view-dependent RGB
head, coarse samples along each ray, optional hierarchical fine sampling
from the coarse weights (a second field), NDC rays and opaque-background
compositing.

Mixed precision follows the JAX package: the MLPs run in ``compute_dtype``
(bf16 under ``trainer.amp_config``), the density is taken out in float32,
the RGB sigmoid and the compositing run in float32.

The random draws (the stratified jitter and the density noise of
``density_noise_reg``) come from the caller's ``torch.Generator``, or from
``draws`` where the caller hands them in (the parity tests hand in JAX's):
``{"coarse": uniforms [B,R,N,1], "noise": normals [B,R,N], "noise_fine":
normals [B,R,N+N_fine]}``, each key optional.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.models.mlp import MLPwithSkipConnection
from mlinerf_tpu_torch.utils import camera, render
from mlinerf_tpu_torch.utils import encoding as enc
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.misc import get_activation


def _with_pe(x, num_freq: int):
    """x followed by its positional encoding (x alone for 0 frequencies)."""
    return torch.cat([x, enc.positional_encoding(x, num_freq)], dim=-1) if num_freq else x


class NeRFField(nn.Module):
    """Density and view-dependent colour at points: ``mlp_feat`` maps the
    encoded point to a density and a feature, ``mlp_rgb`` the feature and
    the encoded view direction to RGB. ``input_3D_dim`` is the width of
    :meth:`encode_3D`'s output (subclasses with another encoding set it)."""

    def __init__(self, cfg_model, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32,
                 input_3D_dim: Optional[int] = None):
        super().__init__()
        cfg = cfg_model
        self.compute_dtype = compute_dtype
        self.view_dep = cfg.view_dep
        self.L_3D = cfg.posenc.L_3D
        self.L_view = cfg.posenc.L_view
        if input_3D_dim is None:
            input_3D_dim = 3 + 6 * self.L_3D if self.L_3D else 3
        layers_feat = list(cfg.mlp.layers_feat)
        layers_feat[0] = input_3D_dim
        layers_feat[-1] += 1  # the density
        self.mlp_feat = MLPwithSkipConnection(layers_feat, generator, skip_connection=cfg.mlp.skip,
                                              compute_dtype=compute_dtype)
        layers_rgb = list(cfg.mlp.layers_rgb)
        input_view_dim = (3 + 6 * self.L_view if self.L_view else 3) if self.view_dep else 0
        layers_rgb[0] = cfg.mlp.layers_feat[-1] + input_view_dim
        self.mlp_rgb = MLPwithSkipConnection(layers_rgb, generator, compute_dtype=compute_dtype)
        self.density_activ = get_activation(cfg.density_activ)

    def encode_3D(self, points):
        return _with_pe(points, self.L_3D)

    def forward(self, points_3D, ray_unit, density_reg: Optional[float] = None, noise=None):
        """points_3D, ray_unit [..., 3] -> (rgb [..., 3], density [...]),
        both float32. With ``density_reg``, ``noise * density_reg`` (noise:
        standard normals [...]) is added to the raw density."""
        out = self.mlp_feat(self.encode_3D(points_3D).to(self.compute_dtype))
        density = out[..., 0].float()
        feat = F.relu(out[..., 1:])
        if density_reg is not None:
            density = density + noise * density_reg
        density = self.density_activ(density)
        if self.view_dep:
            feat = torch.cat([feat, _with_pe(ray_unit, self.L_view).to(feat.dtype)], dim=-1)
        rgb = torch.sigmoid(self.mlp_rgb(feat).float())
        return rgb, density


@register("model", "nerf")
class Model(nn.Module):
    """The NeRF renderer: a coarse field and, with ``fine_sampling``, a
    fine one (``nerf``, ``nerf_fine``: the JAX package's parameter names)."""

    field_cls = NeRFField

    def __init__(self, cfg_model, cfg_data, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg_model = cfg_model
        self.cfg_data = cfg_data
        self.fine_sampling = cfg_model.fine_sampling
        self.density_reg = cfg_model.get("density_noise_reg")
        self.opaque_background = cfg_model.opaque_background
        self.bgcolor = cfg_data.get("bgcolor", 1.0)
        self.nerf = self.field_cls(cfg_model, generator, compute_dtype)
        if self.fine_sampling:
            self.nerf_fine = self.field_cls(cfg_model, generator, compute_dtype)

    def _composite(self, rgbs, densities, dists):
        weights = render.volume_rendering_weights_dist(densities, dists)
        opacity = render.composite_opacity(weights)
        rgb = render.composite(rgbs, weights)
        if self.opaque_background:
            rgb = rgb + self.bgcolor * (1 - opacity)
        return rgb, render.composite(dists, weights), opacity, weights

    def _field(self, field, center, ray_unit, dists, density_reg, noise_key, generator, draws):
        points = camera.get_3D_points_from_dist(center, ray_unit, dists)  # [B,R,N,3]
        noise = None
        if density_reg is not None:
            noise = draws.get(noise_key)
            noise = (torch.randn(points.shape[:-1], generator=generator, device=points.device) if noise is None
                     else noise.to(points.device))
        return field(points, ray_unit[..., None, :].expand_as(points), density_reg=density_reg, noise=noise)

    def render_rays(self, center, ray_unit, stratified: bool = False, generator: Optional[torch.Generator] = None,
                    train: bool = True, draws: Optional[Dict[str, torch.Tensor]] = None):
        """Render rays [B,R,3] (unit directions): ``rgb``, ``dist``,
        ``opacity`` [B,R,K] of the coarse field, and with fine sampling
        ``rgb_fine``, ``dist_fine``, ``opacity_fine``."""
        cfg = self.cfg_model
        draws = draws or {}
        dist_range = tuple(float(np.float32(v)) for v in cfg.dist.range)
        dists = samp.sample_dists(ray_unit.shape[:-1], dist_range, cfg.sample_intvs, stratified,
                                  generator=generator, device=ray_unit.device, rands=draws.get("coarse"))
        if cfg.dist.get("param", "metric") == "inverse":
            dists = 1.0 / (dists + 1e-8)
        density_reg = self.density_reg if train else None
        rgbs, densities = self._field(self.nerf, center, ray_unit, dists, density_reg, "noise", generator, draws)
        rgb, dist, opacity, weights = self._composite(rgbs, densities, dists)
        output = dict(rgb=rgb, dist=dist, opacity=opacity)
        if self.fine_sampling:
            with torch.no_grad():  # the fine samples carry no gradient
                dists_mid = 0.5 * (dists[..., :-1, :] + dists[..., 1:, :])
                dists_fine = samp.sample_dists_from_pdf(dists_mid, weights[..., 1:-1, 0], cfg.sample_intvs_fine)
                dists_all = torch.sort(torch.cat([dists, dists_fine], dim=-2), dim=-2, stable=True).values
            rgbs, densities = self._field(self.nerf_fine, center, ray_unit, dists_all, density_reg, "noise_fine",
                                          generator, draws)
            rgb, dist, opacity, _ = self._composite(rgbs, densities, dists_all)
            output.update(rgb_fine=rgb, dist_fine=dist, opacity_fine=opacity)
        return output

    def forward(self, data, cond=None, generator: Optional[torch.Generator] = None, train: bool = True,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """Render the pre-picked rays of each image: pose [B,3,4], intr
        [B,3,3], ray_idx [B,R]; NDC rays with ``camera_ndc``."""
        center, ray = camera.get_center_and_ray(data["pose"], data["intr"], self.cfg_data.train.image_size)
        center = samp.slice_by_ray_idx(center, data["ray_idx"])
        ray = samp.slice_by_ray_idx(ray, data["ray_idx"])
        if self.cfg_model.camera_ndc:
            center, ray = camera.convert_NDC(center, ray, intr=data["intr"])
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        return self.render_rays(center, ray_unit, stratified=self.cfg_model.sample_stratified and train,
                                generator=generator, train=train, draws=draws)

    def render_chunk(self, center, ray, cond=None, **_):
        """Inference on full-image rays [B,R,3]: midpoint samples, no
        density noise, plus ``depth`` (and ``depth_fine``): the composited
        distance over the ray's length. Like the JAX package's, these rays
        are not converted to NDC under ``camera_ndc``."""
        ray_norm = torch.linalg.norm(ray, dim=-1, keepdim=True)
        out = self.render_rays(center, ray / ray_norm, stratified=False, train=False)
        out["depth"] = out["dist"] / ray_norm
        if self.fine_sampling:
            out["depth_fine"] = out["dist_fine"] / ray_norm
        return out
