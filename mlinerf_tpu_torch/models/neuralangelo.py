"""Neuralangelo geometry: hash-grid SDF, hierarchical NeuS sampling, NeuS
alphas with cosine annealing, and numerical (tap-batched) SDF gradients.

The gradient is numerical (4 or 6 taps). By default the taps take one
exact field evaluation, every hash level is gathered for the sampling
evaluations and the table gradient is the exact 8-corner scatter, as in
the reference. The JAX package's fast-path semantics are selected by
config, as there: the shared-level stencil (``gradient.shared_levels``, an
int or ``auto``, with ``gradient.hessian.mode`` ``shared`` or ``exact``),
blocked dense levels, ``render.sampling_levels``, the corner-sampled table
gradient, the importance-subsampled gradient (``gradient.subsample``) and
the occupancy grid (``render.occupancy``). A config that selects a branch
the port does not carry raises ``NotImplementedError`` naming its key
(:func:`check_ported`).

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
from mlinerf_tpu_torch.ops import occupancy as occ_ops
from mlinerf_tpu_torch.utils import camera, geometry, render
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.misc import require_ported as _require


def check_ported(cfg_model, cfg_data, compute_dtype=torch.float32):
    """Raise NotImplementedError, naming the key, for a config branch the
    port does not carry."""
    _require(compute_dtype == torch.float32, "trainer.amp_config.enabled")
    sdf = cfg_model.object.sdf
    _require(sdf.encoding.type == "hashgrid", "model.object.sdf.encoding.type")
    _require(sdf.gradient.mode == "numerical", "model.object.sdf.gradient.mode")
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

    def __init__(self, cfg_model, cfg_data, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_ported(cfg_model, cfg_data, compute_dtype)
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
        return self.neural_sdf(points, level_mask=cond.get("level_mask"), with_sdf=True, with_feat=False,
                               max_levels=cond.get("max_levels"), corner_draw=cond.get("corner_draw"))[0]

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
        evaluations here build no graph.

        ``render.sampling_levels`` K gathers only the first min(K, cap)
        hash levels in these evaluations. With ``render.occupancy`` on and
        a grid in ``cond["occupancy_grid"]`` the coarse samples follow the
        grid's occupancy profile along the ray."""
        cfgr = self.cfg_render
        num_hier = cfgr.num_sample_hierarchy
        sampling_cond = cond
        k_sampling = cfgr.get("sampling_levels")
        if k_sampling:
            cap = cond.get("max_levels")
            sampling_cond = dict(cond, max_levels=int(k_sampling) if cap is None else min(int(k_sampling), int(cap)))
        occ_cfg = cfgr.get("occupancy") or {}
        if occ_cfg.get("enabled") and cond.get("occupancy_grid") is not None:
            hg = self.cfg_model.object.sdf.encoding.hashgrid
            dists = occ_ops.occupancy_coarse_dists(
                cond["occupancy_grid"], center, ray_unit, near, far, cfgr.num_samples.coarse,
                float(hg.range[0]), float(hg.range[1]), march_bins=int(occ_cfg.get("march_bins", 128)),
                floor=float(occ_cfg.get("floor", 0.02)), stratified=stratified, generator=generator)
        else:
            dists = samp.sample_dists(ray_unit.shape[:-1], (near[..., None], far[..., None]),
                                      cfgr.num_samples.coarse, stratified, generator=generator,
                                      device=ray_unit.device)
        if num_hier > 0:
            points = camera.get_3D_points_from_dist(center, ray_unit, dists)
            sdfs = self.sdf_only(points, sampling_cond)[..., 0]  # [B,R,N]
        for h in range(num_hier):
            weights = samp.neus_pdf_weights(dists, sdfs, inv_s=64 * 2**h)
            dists_fine = samp.sample_dists_from_pdf(dists, weights, cfgr.num_samples.fine)
            dists = torch.cat([dists, dists_fine], dim=-2)
            sorted_dists, sort_idx = torch.sort(dists[..., 0], dim=-1, stable=True)
            dists = sorted_dists[..., None]
            if h != num_hier - 1:
                points_fine = camera.get_3D_points_from_dist(center, ray_unit, dists_fine)
                sdfs_fine = self.sdf_only(points_fine, sampling_cond)[..., 0]
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

    def shared_levels(self, cond) -> int:
        """Levels on the stencil's shared path: ``gradient.shared_levels``,
        or for ``auto`` every level but the finest live one (the cap
        ``cond["max_levels"]`` minus 1, or the level count minus 1)."""
        shared = self.cfg_model.object.sdf.gradient.get("shared_levels") or 0
        if shared == "auto":
            cap = cond.get("max_levels")
            return max((int(cap) if cap is not None else self.cfg_model.object.sdf.encoding.levels) - 1, 0)
        return int(shared)

    def eval_field_with_gradients(self, points, outside, cond, train: bool):
        """Centre SDF + feature head and the SDF gradients. Returns (sdfs
        [...,1], feats [...,W], gradients [...,3], hessians [...,3] or None).

        With shared levels (``gradient.shared_levels``) the centre and the
        taps go through one stencil pass (:meth:`NeuralSDF.stencil`). Its
        shared-level tap features are linear in the offset, so with
        ``gradient.hessian.mode: exact`` training re-estimates the hessian
        from exact taps on every k-th sample (k = round(1 / fraction)),
        pre-masked outside the bounds. Otherwise the centre and the taps
        are two evaluations, as in the reference."""
        grad_cfg = self.cfg_model.object.sdf.gradient
        shared = self.shared_levels(cond)
        if shared <= 0:
            sdfs, feats = self.neural_sdf(points, level_mask=cond.get("level_mask"),
                                          max_levels=cond.get("max_levels"), corner_draw=cond.get("corner_draw"))
            sdfs = torch.where(outside[..., None], torch.full_like(sdfs, self.outside_val), sdfs)
            gradients, hessians = self.compute_gradients(points, cond, training=train, sdf=sdfs)
            return sdfs, feats, gradients, hessians
        taps = grad_cfg.taps
        eps = cond["normal_eps"]
        offsets = numerical_gradient_taps(taps, eps, device=points.device)  # [T,3]
        sdfs, feats, sdf_taps = self.neural_sdf.stencil(
            points, offsets, level_mask=cond.get("level_mask"), shared_levels=shared,
            max_levels=cond.get("max_levels"), corner_draw=cond.get("corner_draw"))
        sdfs = torch.where(outside[..., None], torch.full_like(sdfs, self.outside_val), sdfs)
        gradients, hessians = numerical_gradients(sdf_taps, sdfs, taps, eps, train)
        hess_cfg = grad_cfg.get("hessian") or {}
        if train and hess_cfg.get("mode", "shared") == "exact":
            k = max(int(round(1.0 / max(float(hess_cfg.get("fraction", 0.25)), 1e-6))), 1)
            pts_tap = points[..., ::k, :][..., None, :] + offsets  # [...,S/k,T,3]
            sdf_taps_exact = self.sdf_only(pts_tap, cond)[..., 0]
            _, hessians = numerical_gradients(sdf_taps_exact, sdfs[..., ::k, :], taps, eps, True)
            hessians = hessians * (~outside[..., ::k][..., None]).to(hessians.dtype)
        return sdfs, feats, gradients, hessians

    def eval_field_for_render(self, points, outside, cond, train: bool, ray_unit, dists, far):
        """The object render's field evaluation: the importance-subsampled
        gradient path in training with ``gradient.subsample.enabled``, else
        :meth:`eval_field_with_gradients`."""
        sub = self.cfg_model.object.sdf.gradient.get("subsample")
        if train and sub and sub.get("enabled"):
            return self.eval_field_grad_subsampled(points, outside, cond, ray_unit, dists, far)
        return self.eval_field_with_gradients(points, outside, cond, train)

    def eval_field_grad_subsampled(self, points, outside, cond, ray_unit, dists, far):
        """All samples evaluated without autograd, then the ``topk``
        samples of largest compositing weight per ray and every
        ``stride``-th sample (:func:`grad_sample_indices`) evaluated again
        with it and merged by sample index. The forward's values are those
        of the full path; the parameter gradients come from the selected
        samples only, and the hessians are those of the selection."""
        sub = self.cfg_model.object.sdf.gradient.subsample
        with torch.no_grad():
            sdfs_ng, feats_ng, grads_ng, _ = self.eval_field_with_gradients(points, outside, cond, train=False)
            alphas = self.compute_neus_alphas(ray_unit, sdfs_ng, grads_ng, dists, dist_far=far[..., None],
                                              progress=cond["progress"])
            weights = render.alpha_compositing_weights(alphas)[..., 0]  # [B,R,S]
        idx = grad_sample_indices(weights, int(sub.get("topk", 24)), int(sub.get("stride", 8) or 0))
        pts_k = torch.gather(points, -2, idx[..., None].expand(*idx.shape, 3))
        sdfs_k, feats_k, grads_k, hess_k = self.eval_field_with_gradients(pts_k, outside, cond, train=True)
        # Each sample takes its value from its first selection (a sample
        # picked twice gets one copy of the gradient, as JAX's ``.set``).
        S, K = weights.shape[-1], idx.shape[-1]
        first = torch.full_like(weights, K, dtype=torch.int64).scatter_reduce(
            -1, idx, torch.arange(K, device=idx.device).expand_as(idx), reduce="amin")
        src = torch.where(first < K, S + first, torch.arange(S, device=idx.device))  # [B,R,S]

        def merge(full, sel):
            both = torch.cat([full, sel], dim=-2)
            return torch.gather(both, -2, src[..., None].expand(*src.shape, both.shape[-1]))

        return merge(sdfs_ng, sdfs_k), merge(feats_ng, feats_k), merge(grads_ng, grads_k), hess_k

    def with_corner_draw(self, cond, generator, train: bool):
        """``cond`` with the table gradient's corner uniforms
        (``cond["corner_draw"]``) when training with
        ``gradient.corner_sample.enabled``: drawn from ``generator``,
        unless the caller put its own in ``cond``."""
        cs = self.cfg_model.object.sdf.gradient.get("corner_sample") or {}
        if not (train and cs.get("enabled")) or cond.get("corner_draw") is not None:
            return cond
        return dict(cond, corner_draw=hashgrid.generator_draw(generator))

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


def grad_sample_indices(weights, topk: int, stride: int):
    """Per ray, the ``topk`` samples of largest weight (weights [...,S]),
    equal weights in index order as ``jax.lax.top_k`` takes them (a stable
    descending sort), then every ``stride``-th sample (none for 0):
    [..., min(topk, S) + ceil(S / stride)] int64."""
    S = weights.shape[-1]
    idx = torch.sort(weights, dim=-1, descending=True, stable=True).indices[..., :min(topk, S)]
    if stride > 0:
        cov = torch.arange(0, S, stride, device=weights.device).expand(*idx.shape[:-1], -1)
        idx = torch.cat([idx, cov], dim=-1)
    return idx
