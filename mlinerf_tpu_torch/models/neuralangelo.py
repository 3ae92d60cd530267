"""Neuralangelo: an SDF on a hash-grid (or Fourier) encoding, hierarchical
NeuS sampling, NeuS alphas with cosine annealing, the SDF gradients, the
radiance head, the inverse-sphere background NeRF and per-image appearance
embeddings; ``model.type: neuralangelo``. The light-conditioned model
(models/lumen.py) shares the geometry, the sampling and the background.

The SDF gradient is numerical (4 or 6 taps) or, with ``gradient.mode:
analytical``, the autograd gradient with the Hessian diagonal from three
more differentiations (:func:`analytical_gradients`). In the numerical mode
the taps take one exact field evaluation by default, every hash level is
gathered for the sampling evaluations and the table gradient is the exact
8-corner scatter, as in the reference. The JAX package's fast-path
semantics are selected by config, as there: the shared-level stencil
(``gradient.shared_levels``, an int or ``auto``, with ``gradient.hessian.mode``
``shared`` or ``exact``), blocked dense levels, ``render.sampling_levels``,
the corner-sampled table gradient, the importance-subsampled gradient
(``gradient.subsample``) and the occupancy grid (``render.occupancy``); the
sampling levels apply to the hash grid, the stencil and the corner sampling
to the hash grid in the numerical mode only. A config that selects a branch the port does
not carry raises ``NotImplementedError`` naming its key (:func:`check_ported`).

With ``model.background.enabled`` each ray also gets
``render.num_samples.background`` samples beyond its far bound, at
``far / u`` for u spread over (0, 1], whose colours and densities come from
the background NeRF; object and background samples are composited
together. With ``model.appear_embed.enabled`` the radiance heads (and the
background's) read an embedding of the batch's image index (``idx``); a
full-image render, which has no image index, reads the zero embedding.

The per-iteration schedule (progress, the NeuS cosine anneal, the
coarse-to-fine level mask, the normal epsilon) arrives in ``cond``, computed
by :func:`make_cond` as host-side float32 scalars and a numpy mask. A
training step replayed from a CUDA graph gets ``progress`` and
``cos_anneal`` as 0-dim tensors of the step's schedule row instead; the
rest, which sets shapes and taps, keys the graph.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.models.fields import (
    BackgroundNeRF,
    NeuralRGB,
    NeuralSDF,
    make_hashgrid_spec,
    numerical_gradient_taps,
    numerical_gradients,
)
from mlinerf_tpu_torch.ops import hashgrid
from mlinerf_tpu_torch.ops import occupancy as occ_ops
from mlinerf_tpu_torch.utils import camera, geometry, render
from mlinerf_tpu_torch.utils import losses as loss_lib
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.misc import require_ported as _require


def check_ported(cfg_model, cfg_data):
    """Raise NotImplementedError, naming the key, for a config branch the
    port does not carry."""
    _require(cfg_model.object.rgb.get("mode") in ("idr", "no_view_dir", "no_normal"), "model.object.rgb.mode")
    if cfg_model.appear_embed.enabled and not cfg_data.get("num_images"):
        raise ValueError("model.appear_embed.enabled needs data.num_images, the number of training images")


def make_cond(cfg_model, current_iter: int, max_iter: int, warm_up_end: int = 0) -> Dict[str, Any]:
    """Per-iteration schedule inputs: ``progress``, ``normal_eps`` (float32
    scalars), ``cos_anneal`` (the NeuS cosine's two weights, float32),
    ``level_mask`` ([L] float32 or None), ``active_levels`` and
    ``anneal_levels`` (ints, with coarse-to-fine on on the hash grid)."""
    cfg_sdf = cfg_model.object.sdf
    progress = np.float32(current_iter) / np.float32(max_iter)
    cond: Dict[str, Any] = {"progress": progress,
                            "cos_anneal": cos_anneal_weights(progress, cfg_model.object.s_var.anneal_end)}
    if cfg_sdf.encoding.type != "hashgrid":
        # The Fourier SDF: no level mask, a fixed epsilon.
        cond["level_mask"] = None
        cond["normal_eps"] = np.float32(1e-3)
        return cond
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


def cos_anneal_weights(progress, anneal_end: float):
    """(1 - r, r) for the anneal ratio r = min(progress / anneal_end, 1), as
    float32-exact Python floats."""
    with np.errstate(divide="ignore"):
        anneal_ratio = min(np.float32(progress) / np.float32(anneal_end), np.float32(1.0))
    return float(np.float32(1.0) - anneal_ratio), float(anneal_ratio)


def get_iter_cos(true_cos, cos_anneal):
    """Annealed, always non-positive cosine for the NeuS section estimates;
    ``cos_anneal`` is ``cond["cos_anneal"]``, floats or 0-dim tensors."""
    keep, take = cos_anneal
    return -(torch.relu(-true_cos * 0.5 + 0.5) * keep + torch.relu(-true_cos) * take)


def _embedding(num: int, dim: int, generator: torch.Generator) -> nn.Embedding:
    """[num, dim] embedding table drawn N(0, 1/dim), flax ``nn.Embed``'s
    default."""
    table = nn.Embedding(num, dim)
    with torch.no_grad():
        table.weight.copy_(torch.randn(num, dim, generator=generator) / math.sqrt(dim))
    return table


@register("model", "neuralangelo")
class Model(nn.Module):
    """Neuralangelo renderer: the SDF, the NeuS render with the
    ``NeuralRGB`` head, and the background NeRF and appearance embeddings
    where the config turns them on. The light-conditioned model
    (models/lumen.py) swaps the heads and the render."""

    def __init__(self, cfg_model, cfg_data, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_ported(cfg_model, cfg_data)
        self.cfg_model = cfg_model
        self.cfg_data = cfg_data
        self.cfg_render = cfg_model.render
        self.white_background = cfg_model.background.white
        self.with_background = bool(cfg_model.background.enabled)
        self.with_appear_embed = bool(cfg_model.appear_embed.enabled)
        self.anneal_end = cfg_model.object.s_var.anneal_end
        self.outside_val = 1000.0 * (-1 if cfg_model.object.sdf.mlp.get("inside_out", False) else 1)
        self.compute_dtype = compute_dtype
        self.neural_sdf = NeuralSDF(cfg_model.object.sdf, generator, compute_dtype)
        self.neural_rgb = self._build_rgb(generator)
        self.s_var = nn.Parameter(torch.tensor(float(cfg_model.object.s_var.init_val)))
        if self.with_background:
            self.background_nerf = self._build_background(generator)
        if self.with_appear_embed:
            num, dim = int(cfg_data.num_images), int(cfg_model.appear_embed.dim)
            self.appear_embed = _embedding(num, dim, generator)
            if self.with_background:
                self.appear_embed_outside = _embedding(num, dim, generator)
        self.bounding_box_aabb = (cfg_data.bounding_box_aabb if cfg_data.get("bounding_type") == "box"
                                  else None)

    def _build_rgb(self, generator: torch.Generator) -> nn.Module:
        return NeuralRGB(self.cfg_model.object.rgb, feat_dim=self.cfg_model.object.sdf.mlp.hidden_dim,
                         appear_embed=self.cfg_model.appear_embed, generator=generator,
                         compute_dtype=self.compute_dtype)

    def _build_background(self, generator: torch.Generator) -> nn.Module:
        return BackgroundNeRF(self.cfg_model.background, appear_embed=self.cfg_model.appear_embed,
                              generator=generator, compute_dtype=self.compute_dtype)

    def _hashgrid(self) -> bool:
        return self.cfg_model.object.sdf.encoding.type == "hashgrid"

    def _analytical(self) -> bool:
        return self.cfg_model.object.sdf.gradient.mode == "analytical"

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
        if k_sampling and self._hashgrid():
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

    def sample_dists_background(self, ray_unit, far, stratified, generator=None, rands=None, eps=1e-5):
        """``render.num_samples.background`` distances per ray beyond the
        far bound: ``far / (u + eps)`` for u stratified (or at the
        midpoints) over (0, 1], decreasing, so the distances increase. The
        uniforms come from ``generator``, or are ``rands`` [B,R,N,1].
        Returns [B,R,N,1], without gradient."""
        inv_dists = samp.sample_dists(ray_unit.shape[:-1], (1.0, 0.0), self.cfg_render.num_samples.background,
                                      stratified, generator=generator, device=ray_unit.device, rands=rands)
        return (far[..., None] / (inv_dists + eps)).detach()

    # ------------------------------------------------------------------
    # NeuS alphas and SDF gradients
    # ------------------------------------------------------------------

    def compute_neus_alphas(self, ray_unit, sdfs, gradients, dists, dist_far, cos_anneal, eps=1e-5):
        """SDF volume rendering: NeuS CDF-ratio alphas with cos annealing."""
        sdfs = sdfs[..., 0]  # [B,R,N]
        inv_s = torch.exp(self.s_var)
        true_cos = torch.sum(ray_unit[..., None, :] * gradients, dim=-1)
        iter_cos = get_iter_cos(true_cos, cos_anneal)
        dists_aug = torch.cat([dists, dist_far], dim=-2)
        dist_intvs = dists_aug[..., 1:, 0] - dists_aug[..., :-1, 0]
        est_prev_sdf = sdfs - iter_cos * dist_intvs * 0.5
        est_next_sdf = sdfs + iter_cos * dist_intvs * 0.5
        prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
        next_cdf = torch.sigmoid(est_next_sdf * inv_s)
        return torch.clamp((prev_cdf - next_cdf) / (prev_cdf + eps), 0.0, 1.0)

    def compute_gradients(self, points, cond, training: bool, sdf=None):
        """SDF gradients [...,3] and, when training, the Hessian diagonal
        [...,3] (else None). Numerical: every tap in one field evaluation,
        the Hessian from the taps and ``sdf``, the centre's SDF [...,1].
        Analytical: a field evaluation of its own, differentiated
        (:func:`analytical_gradients`)."""
        if self._analytical():
            _, gradient, hessian = self._analytical_field(points, lambda p: (self.sdf_only(p, cond), None), training)
            return gradient, hessian
        taps = self.cfg_model.object.sdf.gradient.taps
        eps = cond["normal_eps"]
        offsets = numerical_gradient_taps(taps, eps, device=points.device)  # [T,3]
        pts_tap = points[..., None, :] + offsets  # [...,T,3]
        sdf_taps = self.sdf_only(pts_tap, cond)[..., 0]  # [...,T]
        return numerical_gradients(sdf_taps, sdf, taps, eps, training)

    @staticmethod
    def _analytical_field(points, field, training: bool):
        """``field(p)`` -> (sdf [...,1], extra) evaluated on a copy of the
        points that requires grad, with autograd on whatever the caller's
        mode, and its analytical gradients. Returns ((sdf, extra), gradient,
        hessian); without autograd at the caller everything comes back
        detached."""
        grad_on = torch.is_grad_enabled()
        with torch.enable_grad():
            points = points.detach().requires_grad_(True)
            sdf, extra = field(points)
            gradient, hessian = analytical_gradients(sdf, points, training)
        if not grad_on:
            sdf, extra, gradient, hessian = (None if t is None else t.detach()
                                             for t in (sdf, extra, gradient, hessian))
        return (sdf, extra), gradient, hessian

    def shared_levels(self, cond) -> int:
        """Levels on the stencil's shared path: ``gradient.shared_levels``,
        or for ``auto`` every level but the finest live one (the cap
        ``cond["max_levels"]`` minus 1, or the level count minus 1); 0 in
        the analytical mode and on the Fourier SDF."""
        if self._analytical() or not self._hashgrid():
            return 0
        shared = self.cfg_model.object.sdf.gradient.get("shared_levels") or 0
        if shared == "auto":
            cap = cond.get("max_levels")
            return max((int(cap) if cap is not None else self.cfg_model.object.sdf.encoding.levels) - 1, 0)
        return int(shared)

    def eval_field_with_gradients(self, points, outside, cond, train: bool):
        """Centre SDF + feature head and the SDF gradients. Returns (sdfs
        [...,1], feats [...,W], gradients [...,3], hessians [...,3] or None).

        Analytical: one field evaluation, differentiated for the gradient
        and the Hessian (the JAX package evaluates the SDF a second time
        for them; the values are the same, and each hash level's table
        gradient is then one scatter). With shared levels
        (``gradient.shared_levels``) the centre and the taps go through one
        stencil pass (:meth:`NeuralSDF.stencil`). Its shared-level tap
        features are linear in the offset, so with ``gradient.hessian.mode:
        exact`` training re-estimates the hessian from exact taps on every
        k-th sample (k = round(1 / fraction)), pre-masked outside the
        bounds. Otherwise the centre and the taps are two evaluations, as
        in the reference."""
        grad_cfg = self.cfg_model.object.sdf.gradient
        field_kwargs = dict(level_mask=cond.get("level_mask"), max_levels=cond.get("max_levels"))
        if self._analytical():
            (sdfs, feats), gradients, hessians = self._analytical_field(
                points, lambda p: self.neural_sdf(p, **field_kwargs), train)
            sdfs = torch.where(outside[..., None], torch.full_like(sdfs, self.outside_val), sdfs)
            return sdfs, feats, gradients, hessians
        shared = self.shared_levels(cond)
        if shared <= 0:
            sdfs, feats = self.neural_sdf(points, corner_draw=cond.get("corner_draw"), **field_kwargs)
            sdfs = torch.where(outside[..., None], torch.full_like(sdfs, self.outside_val), sdfs)
            gradients, hessians = self.compute_gradients(points, cond, training=train, sdf=sdfs)
            return sdfs, feats, gradients, hessians
        taps = grad_cfg.taps
        eps = cond["normal_eps"]
        offsets = numerical_gradient_taps(taps, eps, device=points.device)  # [T,3]
        sdfs, feats, sdf_taps = self.neural_sdf.stencil(points, offsets, shared_levels=shared,
                                                        corner_draw=cond.get("corner_draw"), **field_kwargs)
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
                                              cos_anneal=cond["cos_anneal"])
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
        if not (train and cs.get("enabled") and self._hashgrid() and not self._analytical()) \
                or cond.get("corner_draw") is not None:
            return cond
        return dict(cond, corner_draw=hashgrid.generator_draw(generator))

    # ------------------------------------------------------------------
    # Rendering
    # ------------------------------------------------------------------

    def get_appearance_embedding(self, sample_idx, batch_size: int, device):
        """(app, app_outside): the embeddings [B,D] of images ``sample_idx``
        [B] (the zero embedding where it is None) for the object's and the
        background's heads; None where embeddings, or the background, are
        off."""
        if not self.with_appear_embed:
            return None, None
        tables = [self.appear_embed] + ([self.appear_embed_outside] if self.with_background else [None])
        if sample_idx is None:
            dim = self.appear_embed.embedding_dim
            return tuple(None if t is None else torch.zeros(batch_size, dim, device=device) for t in tables)
        idx = sample_idx.to(device=device, dtype=torch.int64)
        return tuple(None if t is None else t(idx) for t in tables)

    @staticmethod
    def expand_per_sample(app, points):
        """A per-image embedding [B,D] for every sample of points [B,R,N,3]."""
        return None if app is None else app[:, None, None, :].expand(*points.shape[:-1], app.shape[-1])

    def render_rays(self, center, ray_unit, cond, sample_idx=None, stratified: bool = False,
                    generator: Optional[torch.Generator] = None, train: bool = True):
        """Render rays [B,R,3] of images ``sample_idx`` [B] (for the
        appearance embeddings). Object and background samples are
        composited together, and a white background adds the
        transmittance. Returns rgb, opacity (object samples; inference
        only), outside, dists and weights (all samples), gradient
        (inference only), gradients and hessians."""
        cond = self.with_corner_draw(cond, generator, train)
        near, far, outside = self.get_dist_bounds(center, ray_unit)
        app, app_outside = self.get_appearance_embedding(sample_idx, center.shape[0], center.device)
        out_obj = self.render_rays_object(center, ray_unit, near, far, outside, app, cond, stratified, generator,
                                          train)
        rgbs, dists, alphas = out_obj["rgbs"], out_obj["dists"], out_obj["alphas"]
        if self.with_background:
            out_bg = self.render_rays_background(center, ray_unit, far, app_outside, stratified, generator)
            rgbs = torch.cat([rgbs, out_bg["rgbs"]], dim=-2)
            dists = torch.cat([dists, out_bg["dists"]], dim=-2)
            alphas = torch.cat([alphas, out_bg["alphas"]], dim=-1)
        weights = render.alpha_compositing_weights(alphas)
        rgb = render.composite(rgbs, weights)
        if self.white_background:
            rgb = rgb + (1 - render.composite_opacity(weights))
        return dict(rgb=rgb, opacity=out_obj["opacity"], outside=outside, dists=dists, weights=weights,
                    gradient=out_obj["gradient"], gradients=out_obj["gradients"], hessians=out_obj["hessians"])

    def render_rays_object(self, center, ray_unit, near, far, outside, app, cond, stratified, generator,
                           train: bool):
        dists = self.sample_dists_all(center, ray_unit, near, far, cond, stratified, generator)
        points = camera.get_3D_points_from_dist(center, ray_unit, dists)
        sdfs, feats, gradients, hessians = self.eval_field_for_render(points, outside, cond, train, ray_unit,
                                                                      dists, far)
        rays_unit = ray_unit[..., None, :].expand_as(points)
        normals = loss_lib.safe_normalize(gradients)
        rgbs = self.neural_rgb(points, normals, rays_unit, feats, app=self.expand_per_sample(app, points))
        alphas = self.compute_neus_alphas(ray_unit, sdfs, gradients, dists, dist_far=far[..., None],
                                          cos_anneal=cond["cos_anneal"])
        opacity = gradient = None
        if not train:
            weights = render.alpha_compositing_weights(alphas)
            opacity = render.composite_opacity(weights)
            gradient = render.composite(gradients, weights)
        return dict(rgbs=rgbs, sdfs=sdfs[..., 0], dists=dists, alphas=alphas, opacity=opacity, gradient=gradient,
                    gradients=gradients, hessians=hessians)

    def render_rays_background(self, center, ray_unit, far, app_outside, stratified, generator, pts_light=None):
        """The background samples' rgbs [B,R,N,3], dists [B,R,N,1] and
        alphas [B,R,N]; the light-conditioned background reads
        ``pts_light`` [B,R,3]."""
        dists = self.sample_dists_background(ray_unit, far, stratified, generator)
        points = camera.get_3D_points_from_dist(center, ray_unit, dists)
        rays_unit = ray_unit[..., None, :].expand_as(points)
        if pts_light is not None:
            pts_light = pts_light[..., None, :].expand_as(points)
        rgbs, densities = self.background_nerf(points, rays_unit, pts_light=pts_light,
                                               app_outside=self.expand_per_sample(app_outside, points))
        return dict(rgbs=rgbs, dists=dists, alphas=render.volume_rendering_alphas_dist(densities, dists))

    def forward(self, data, cond, generator: Optional[torch.Generator] = None, train: bool = True):
        """Render the pre-picked rays of each image.

        data: pose [B,3,4], intr [B,3,3], ray_idx [B,R], idx [B].
        """
        center, ray_unit = self.picked_rays(data)
        return self.render_rays(center, ray_unit, cond, sample_idx=data["idx"] if self.with_appear_embed else None,
                                stratified=self.cfg_render.stratified and train, generator=generator, train=train)

    def picked_rays(self, data):
        """Centres and unit directions [B,R,3] of the picked pixels."""
        center, ray = camera.get_center_and_ray(data["pose"], data["intr"], self.cfg_data.train.image_size)
        center = samp.slice_by_ray_idx(center, data["ray_idx"])
        ray = samp.slice_by_ray_idx(ray, data["ray_idx"])
        return center, ray / torch.linalg.norm(ray, dim=-1, keepdim=True)

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


def analytical_gradients(sdf, points, training: bool):
    """Gradient [...,3] of ``sdf`` [...,1] with respect to ``points``
    [...,3] (each SDF value depends on its own point only) and, when
    training, the Hessian diagonal [...,3]: three more differentiations,
    one per axis, each of the gradient's component along that axis. The
    graph of the gradient (and of the Hessian) is kept for the backward
    when training; else the gradient is detached and the Hessian None.
    The field's own graph stays alive for the caller."""
    (gradient,) = torch.autograd.grad(sdf.sum(), points, create_graph=training, retain_graph=True)
    if not training:
        return gradient.detach(), None
    hessian = torch.stack([torch.autograd.grad(gradient[..., d].sum(), points, create_graph=True)[0][..., d]
                           for d in range(3)], dim=-1)
    return gradient, hessian
