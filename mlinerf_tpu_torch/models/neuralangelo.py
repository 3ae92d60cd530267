"""Neuralangelo geometry: hash-grid SDF, hierarchical NeuS sampling, NeuS
alphas with cosine annealing, and numerical (tap-batched) SDF gradients.

The port carries the reference-exact branch: 4- or 6-tap numerical
gradients with one exact field evaluation for the taps (no shared-level
stencil), every hash level gathered for the sampling evaluations, the exact
8-corner table gradient. A config that selects another branch raises
``NotImplementedError`` naming its key (:func:`check_ported`).

The per-iteration schedule (progress, coarse-to-fine level mask, normal
epsilon) arrives in ``cond`` as host-side float32 scalars and a numpy mask,
computed by :func:`make_cond`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from mlinerf_tpu_torch.models.fields import (
    NeuralSDF,
    make_hashgrid_spec,
    numerical_gradient_taps,
    numerical_gradients,
)
from mlinerf_tpu_torch.ops import hashgrid
from mlinerf_tpu_torch.utils import camera, geometry, render
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.misc import require_ported as _require


def check_ported(cfg_model, cfg_data):
    """Raise NotImplementedError, naming the key, for a config branch the
    port does not carry."""
    sdf = cfg_model.object.sdf
    grad = sdf.gradient
    render_cfg = cfg_model.render
    _require(sdf.encoding.type == "hashgrid", "model.object.sdf.encoding.type")
    _require(not sdf.encoding.hashgrid.get("dense_blocked"), "model.object.sdf.encoding.hashgrid.dense_blocked")
    _require(grad.mode == "numerical", "model.object.sdf.gradient.mode")
    _require(not grad.get("shared_levels"), "model.object.sdf.gradient.shared_levels")
    _require(not (grad.get("corner_sample") or {}).get("enabled"),
             "model.object.sdf.gradient.corner_sample.enabled")
    _require(not (grad.get("subsample") or {}).get("enabled"), "model.object.sdf.gradient.subsample.enabled")
    _require(not render_cfg.get("sampling_levels"), "model.render.sampling_levels")
    _require(not (render_cfg.get("occupancy") or {}).get("enabled"), "model.render.occupancy.enabled")
    _require(not cfg_model.background.enabled, "model.background.enabled")
    _require(not cfg_model.appear_embed.enabled, "model.appear_embed.enabled")
    _require(cfg_model.object.rgb.encoding_view.type == "spherical", "model.object.rgb.encoding_view.type")
    _require(cfg_model.object.rgb.get("mode") in ("idr", "no_view_dir", "no_normal"), "model.object.rgb.mode")


def make_cond(cfg_model, current_iter: int, max_iter: int, warm_up_end: int = 0) -> Dict[str, Any]:
    """Per-iteration schedule inputs: ``progress``, ``normal_eps`` (float32
    scalars), ``level_mask`` ([L] float32 or None), ``active_levels`` and
    ``anneal_levels`` (ints, with coarse-to-fine on)."""
    cfg_sdf = cfg_model.object.sdf
    cond: Dict[str, Any] = {"progress": np.float32(current_iter) / np.float32(max_iter)}
    num_levels = cfg_sdf.encoding.levels
    resolutions = np.asarray(make_hashgrid_spec(cfg_sdf.encoding).resolutions, np.float32)
    c2f = cfg_sdf.encoding.coarse2fine
    if c2f.enabled:
        anneal_levels = min(max((current_iter - warm_up_end) // c2f.step, 1), num_levels)
        active_levels = max(c2f.init_active_level, anneal_levels)
        cond["active_levels"] = active_levels
        cond["anneal_levels"] = anneal_levels
        cond["level_mask"] = hashgrid.active_levels_to_mask(active_levels, num_levels)
        eps_res = resolutions[anneal_levels - 1]
    else:
        cond["level_mask"] = None
        eps_res = resolutions[-1]
    cond["normal_eps"] = np.float32(1.0) / eps_res
    return cond


def get_iter_cos(true_cos, progress, anneal_end: float):
    """Annealed, always non-positive cosine for the NeuS section estimates."""
    anneal_ratio = min(np.float32(progress) / np.float32(anneal_end), np.float32(1.0))
    return -(torch.relu(-true_cos * 0.5 + 0.5) * float(np.float32(1.0) - anneal_ratio)
             + torch.relu(-true_cos) * float(anneal_ratio))


class Model(nn.Module):
    """Geometry and sampling shared by the light-conditioned model
    (models/lumen.py), which adds the radiance head and the render."""

    def __init__(self, cfg_model, cfg_data, generator: torch.Generator):
        super().__init__()
        check_ported(cfg_model, cfg_data)
        self.cfg_model = cfg_model
        self.cfg_data = cfg_data
        self.cfg_render = cfg_model.render
        self.white_background = cfg_model.background.white
        self.anneal_end = cfg_model.object.s_var.anneal_end
        self.outside_val = 1000.0 * (-1 if cfg_model.object.sdf.mlp.get("inside_out", False) else 1)
        self.neural_sdf = NeuralSDF(cfg_model.object.sdf, generator)
        self.neural_rgb = self._build_rgb(generator)
        self.s_var = nn.Parameter(torch.tensor(float(cfg_model.object.s_var.init_val)))
        self.bounding_box_aabb = (cfg_data.bounding_box_aabb if cfg_data.get("bounding_type") == "box"
                                  else None)

    def _build_rgb(self, generator: torch.Generator) -> nn.Module:
        raise NotImplementedError("model.type: the Neuralangelo radiance head (NeuralRGB) is not ported")

    # ------------------------------------------------------------------
    # Geometry helpers
    # ------------------------------------------------------------------

    def get_dist_bounds(self, center, ray_unit):
        if self.bounding_box_aabb is not None:
            near, far, outside = geometry.dist_bounds_aabb(center, ray_unit, self.bounding_box_aabb)
        else:
            near, far, outside = geometry.dist_bounds_sphere(center, ray_unit, radius=1.0)
        return near.detach(), far.detach(), outside

    def sdf_only(self, points, cond):
        """SDF at points (no feature head)."""
        return self.neural_sdf(points, level_mask=cond.get("level_mask"), with_sdf=True,
                               with_feat=False, max_levels=cond.get("max_levels"))[0]

    def sphere_trace(self, center, ray_unit, near, far, cond, num_iters=20, dist_start=None):
        """Surface hit along each ray by sphere tracing the SDF (no graph)."""
        return geometry.sphere_tracing_intersection(
            lambda pts: self.sdf_only(pts, cond), center, ray_unit, near, far,
            num_iters=num_iters, dist_start=dist_start)

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    @torch.no_grad()
    def sample_dists_all(self, center, ray_unit, near, far, cond, stratified, generator):
        """Coarse + hierarchical NeuS importance sampling. Runs without
        autograd: the sample positions carry no gradient, and the SDF
        evaluations here build no graph."""
        cfgr = self.cfg_render
        num_hier = cfgr.num_sample_hierarchy
        dists = samp.sample_dists(ray_unit.shape[:-1], (near[..., None], far[..., None]),
                                  cfgr.num_samples.coarse, stratified, generator=generator,
                                  device=ray_unit.device)
        if num_hier > 0:
            points = camera.get_3D_points_from_dist(center, ray_unit, dists)
            sdfs = self.sdf_only(points, cond)[..., 0]  # [B,R,N]
        for h in range(num_hier):
            weights = samp.neus_pdf_weights(dists, sdfs, inv_s=64 * 2**h)
            dists_fine = samp.sample_dists_from_pdf(dists, weights, cfgr.num_samples.fine)
            dists = torch.cat([dists, dists_fine], dim=-2)
            sorted_dists, sort_idx = torch.sort(dists[..., 0], dim=-1, stable=True)
            dists = sorted_dists[..., None]
            if h != num_hier - 1:
                points_fine = camera.get_3D_points_from_dist(center, ray_unit, dists_fine)
                sdfs_fine = self.sdf_only(points_fine, cond)[..., 0]
                sdfs = torch.gather(torch.cat([sdfs, sdfs_fine], dim=-1), -1, sort_idx)
        return dists

    # ------------------------------------------------------------------
    # NeuS alphas and SDF gradients
    # ------------------------------------------------------------------

    def compute_neus_alphas(self, ray_unit, sdfs, gradients, dists, dist_far, progress, eps=1e-5):
        """SDF volume rendering: NeuS CDF-ratio alphas with cos annealing."""
        sdfs = sdfs[..., 0]  # [B,R,N]
        inv_s = torch.exp(self.s_var)
        true_cos = torch.sum(ray_unit[..., None, :] * gradients, dim=-1)
        iter_cos = get_iter_cos(true_cos, progress, self.anneal_end)
        dists_aug = torch.cat([dists, dist_far], dim=-2)
        dist_intvs = dists_aug[..., 1:, 0] - dists_aug[..., :-1, 0]
        est_prev_sdf = sdfs - iter_cos * dist_intvs * 0.5
        est_next_sdf = sdfs + iter_cos * dist_intvs * 0.5
        prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
        next_cdf = torch.sigmoid(est_next_sdf * inv_s)
        return torch.clamp((prev_cdf - next_cdf) / (prev_cdf + eps), 0.0, 1.0)

    def compute_gradients(self, points, cond, training: bool, sdf=None):
        """Numerical SDF gradients: every tap in one field evaluation."""
        taps = self.cfg_model.object.sdf.gradient.taps
        eps = cond["normal_eps"]
        offsets = numerical_gradient_taps(taps, eps, device=points.device)  # [T,3]
        pts_tap = points[..., None, :] + offsets  # [...,T,3]
        sdf_taps = self.sdf_only(pts_tap, cond)[..., 0]  # [...,T]
        return numerical_gradients(sdf_taps, sdf, taps, eps, training)

    def eval_field_with_gradients(self, points, outside, cond, train: bool):
        """Center SDF + feature head, then the tap evaluation for the SDF
        gradients. Returns (sdfs [...,1], feats [...,W], gradients [...,3],
        hessians [...,3] or None)."""
        sdfs, feats = self.neural_sdf(points, level_mask=cond.get("level_mask"),
                                      max_levels=cond.get("max_levels"))
        sdfs = torch.where(outside[..., None], torch.full_like(sdfs, self.outside_val), sdfs)
        gradients, hessians = self.compute_gradients(points, cond, training=train, sdf=sdfs)
        return sdfs, feats, gradients, hessians

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def render_chunk(self, center, ray, cond, **render_kwargs):
        """Inference on a chunk of full-image rays [B,R,3]: midpoint samples,
        the ``train=False`` outputs, plus ``depth`` (the composited distance
        over the ray's length). ``render_kwargs`` go to ``render_rays``."""
        ray_norm = torch.linalg.norm(ray, dim=-1, keepdim=True)
        out = self.render_rays(center, ray / ray_norm, cond, stratified=False, train=False, **render_kwargs)
        out["depth"] = render.composite(out["dists"], out["weights"]) / ray_norm
        return out
