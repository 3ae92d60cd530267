"""MLI-NeRF light-conditioned model: every ray's radiance is conditioned
on its light position. The radiance head bank's network mode (plain
``rgb``, or the intrinsic ``r_s``, ``r_s_re``, ``rgb_r``, ``rgb_r_s``)
decides which of reflectance ``o_r``, shading ``o_s`` and residual ``o_re``
the render composites beside ``rgb``. With light visibility on
(``model.light_visibility``, or ``with_light_visibility=True`` for the
pseudo-label renders) the render also finds each camera ray's surface hit,
tests it for occlusion toward the light and gives the ``normal . light``
pseudo shading.

The background NeRF (``model.background.enabled``) is conditioned on the
light position as well and composited with the object's samples; it goes
with the plain ``rgb`` mode only, as in the JAX package. Appearance
embeddings (``model.appear_embed.enabled``) feed every radiance head.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.models.fields import BackgroundNeRF, LumenRGB
from mlinerf_tpu_torch.models.neuralangelo import Model as AngeloModel
from mlinerf_tpu_torch.utils import camera, geometry, render
from mlinerf_tpu_torch.utils import losses as loss_lib
from mlinerf_tpu_torch.utils import sampling as samp


@register("model", "lumen")
class Model(AngeloModel):
    """Lumen model: Neuralangelo geometry with the light-conditioned head."""

    def __init__(self, cfg_model, cfg_data, generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        super().__init__(cfg_model, cfg_data, generator, compute_dtype)
        if self.with_background and cfg_model.object.rgb.get("network_mode") is not None:
            raise NotImplementedError("model.background.enabled with model.object.rgb.network_mode "
                                      f"'{cfg_model.object.rgb.network_mode}': the background goes with the plain "
                                      "rgb head only (as in the reference)")
        lv = cfg_model.get("light_visibility")
        self.para_light_visibility = lv
        self.flag_light_visibility = bool(lv and lv.enabled)
        # As in the JAX package, the gamma applies only with visibility on in
        # the config, not when a render forces it on.
        self.gamma_for_shading = (float(lv.gamma_correlation)
                                  if self.flag_light_visibility and lv.get("gamma_correlation") else None)

    def _build_rgb(self, generator: torch.Generator):
        return LumenRGB(self.cfg_model.object.rgb, feat_dim=self.cfg_model.object.sdf.mlp.hidden_dim,
                        generator=generator, appear_embed=self.cfg_model.appear_embed,
                        compute_dtype=self.compute_dtype)

    def _build_background(self, generator: torch.Generator):
        return BackgroundNeRF(self.cfg_model.background, appear_embed=self.cfg_model.appear_embed,
                              generator=generator, with_light=True, compute_dtype=self.compute_dtype)

    def render_rays(self, center, ray_unit, cond, pts_light, sample_idx=None, stratified: bool = False,
                    generator: Optional[torch.Generator] = None, train: bool = True,
                    with_light_visibility: Optional[bool] = None):
        """Render rays [B,R,3] of images ``sample_idx`` [B] (for the
        appearance embeddings) lit from ``pts_light`` [B,R,3]. With the
        background on, its samples are composited with the object's. With
        light visibility on, the output adds ``visibility`` and
        ``inter_mask`` (bool), ``normal_x_light``, ``pseudo_shading`` and
        ``inter_dist`` ([B,R,1] each). An intrinsic network mode adds its
        composited ``o_r``, ``o_s`` and ``o_re`` ([B,R,C] each). Training
        with ``gradient.corner_sample`` on draws the corner uniforms from
        ``generator`` (or takes ``cond["corner_draw"]``)."""
        cond = self.with_corner_draw(cond, generator, train)
        near, far, outside = self.get_dist_bounds(center, ray_unit)
        app, app_outside = self.get_appearance_embedding(sample_idx, center.shape[0], center.device)
        out_obj = self.render_rays_object_lumen(center, ray_unit, pts_light, near, far, outside, app,
                                                cond, stratified, generator, train)
        if self.with_background:
            out_bg = self.render_rays_background(center, ray_unit, far, app_outside, stratified, generator,
                                                 pts_light=pts_light)
            out_obj = dict(out_obj, **{k: torch.cat([out_obj[k], out_bg[k]], dim=-1 if k == "alphas" else -2)
                                       for k in ("rgbs", "dists", "alphas")})
        weights = render.alpha_compositing_weights(out_obj["alphas"])
        opacity_all = render.composite_opacity(weights)
        rgb, intrinsic = self.composite_intrinsic(out_obj, weights, opacity_all)
        output = dict(
            rgb=rgb,
            opacity=out_obj["opacity"],
            outside=outside,
            dists=out_obj["dists"],
            weights=weights,
            gradient=out_obj["gradient"],
            gradients=out_obj["gradients"],
            hessians=out_obj["hessians"],
            **intrinsic,
        )
        use_vis = self.flag_light_visibility if with_light_visibility is None else with_light_visibility
        if use_vis:
            visibility, normal_x_light, inter_dist, inter_mask = self.get_light_visibility(
                center, ray_unit, pts_light, near, far, outside, output, cond, stratified, generator)
            pseudo_shading = normal_x_light * visibility.float()
            if self.gamma_for_shading:
                pseudo_shading = torch.pow(pseudo_shading, 1.0 / self.gamma_for_shading)
            output.update(visibility=visibility, normal_x_light=normal_x_light,
                          pseudo_shading=pseudo_shading, inter_dist=inter_dist, inter_mask=inter_mask)
        return output

    def render_rays_object_lumen(self, center, ray_unit, pts_light, near, far, outside, app,
                                 cond, stratified, generator, train: bool):
        dists = self.sample_dists_all(center, ray_unit, near, far, cond, stratified, generator)
        points = camera.get_3D_points_from_dist(center, ray_unit, dists)
        sdfs, feats, gradients, hessians = self.eval_field_for_render(points, outside, cond, train, ray_unit,
                                                                      dists, far)
        rays_unit = ray_unit[..., None, :].expand_as(points)
        normals = loss_lib.safe_normalize(gradients)
        pts_light_expand = pts_light[..., None, :].expand_as(points)
        heads = self.neural_rgb(points, normals, rays_unit, feats, pts_light_expand,
                                app=self.expand_per_sample(app, points))
        rgbs = heads.pop("rgb", None)  # none in r_s / r_s_re
        alphas = self.compute_neus_alphas(ray_unit, sdfs, gradients, dists,
                                          dist_far=far[..., None], cos_anneal=cond["cos_anneal"])
        # Inference composites opacity and the normal; training with light
        # visibility on needs the normal only.
        opacity = gradient = None
        if not train or self.flag_light_visibility:
            weights = render.alpha_compositing_weights(alphas)
            gradient = render.composite(gradients, weights)
            if not train:
                opacity = render.composite_opacity(weights)
        return dict(rgbs=rgbs, sdfs=sdfs[..., 0], dists=dists, alphas=alphas, opacity=opacity,
                    gradient=gradient, gradients=gradients, hessians=hessians, **heads)

    def composite_intrinsic(self, out_obj, weights, opacity_all):
        """The ray's rgb and, per network mode, its composited intrinsic
        components. r_s / r_s_re composite reflectance and shading (and the
        residual) and multiply them; rgb_r divides rgb by the composited
        reflectance for shading; rgb_r_s takes the residual as
        ``rgb - o_r * o_s``. A white background adds the transmittance to
        every composited map."""
        mode = self.neural_rgb.network_mode
        white = (1 - opacity_all) if self.white_background else None

        def comp(x):
            out = render.composite(x, weights)
            return out + white if white is not None else out

        intrinsic = {}
        if mode in ("r_s", "r_s_re"):
            for key in ("o_r", "o_s", "o_re") if mode == "r_s_re" else ("o_r", "o_s"):
                intrinsic[key] = comp(out_obj[key])
            rgb = intrinsic["o_r"] * intrinsic["o_s"]
            if mode == "r_s_re":
                rgb = rgb + intrinsic["o_re"]
            return rgb, intrinsic
        rgb = comp(out_obj["rgbs"])
        if mode in ("rgb_r", "rgb_r_s"):
            intrinsic["o_r"] = comp(out_obj["o_r"])
        if mode == "rgb_r":
            intrinsic["o_s"] = rgb / intrinsic["o_r"]
        elif mode == "rgb_r_s":
            intrinsic["o_s"] = comp(out_obj["o_s"])
            intrinsic["o_re"] = rgb - intrinsic["o_r"] * intrinsic["o_s"]
        return rgb, intrinsic

    # ------------------------------------------------------------------
    # Light visibility (the pseudo-label renders)
    # ------------------------------------------------------------------

    def get_dist_bounds_visibility(self, center, ray_unit):
        lv = self.para_light_visibility
        if lv.visibility_bounding_type == "box":
            return geometry.dist_bounds_aabb(center, ray_unit, lv.visibility_bounding_box_aabb)
        return geometry.dist_bounds_sphere(center, ray_unit, radius=lv.visibility_sphere_radius)

    def get_light_visibility(self, center, ray_unit, pts_light, near, far, outside,
                             render_output, cond, stratified, generator):
        """Surface hit along the camera ray, then the occlusion test of the
        segment from the light to that hit. Returns (visibility [...,1]
        bool, normal_x_light [...,1], inter_dist [...,1], inter_mask [...,1]
        bool)."""
        lv = self.para_light_visibility
        camera_ray_type = lv.camera_ray_type
        blend_dist = render.composite(render_output["dists"], render_output["weights"]).detach()
        if camera_ray_type == "blend_z_sphere_tracing":
            inter_dist, inter_pts, inter_mask = self.sphere_trace(center, ray_unit, near, far, cond,
                                                                  dist_start=blend_dist)
        elif camera_ray_type == "blend_z":
            inter_dist = blend_dist
            inter_pts = center + ray_unit * inter_dist
            inter_mask = inter_dist > 0.0
        elif camera_ray_type == "sphere_tracing":
            inter_dist, inter_pts, inter_mask = self.sphere_trace(center, ray_unit, near, far, cond)
        else:
            raise NotImplementedError(f"model.light_visibility.camera_ray_type '{camera_ray_type}'")

        light_loc = pts_light
        light_ray = inter_pts - light_loc
        dists_light_inter = loss_lib.safe_norm(light_ray, dim=-1, keepdim=True)
        light_ray_unit = light_ray / dists_light_inter

        if lv.type == "render_light_visibility":
            near_l, far_l, outside_l = self.get_dist_bounds(light_loc, light_ray_unit)
            inside_space = ~outside & ~outside_l
            visibility = self.render_light_visibility(light_loc, light_ray_unit, near_l, far_l, outside_l,
                                                      dists_light_inter, cond, stratified, generator)
            visibility = (visibility > 0.5) & inside_space
        elif lv.type == "sphere_tracing":
            near_l, far_l, outside_l = self.get_dist_bounds_visibility(light_loc, light_ray_unit)
            far_tracing = dists_light_inter - 1e-3
            inside_bounding = (near_l < far_tracing) & (far_tracing < far_l) & ~outside_l
            _, _, mask_light = self.sphere_trace(light_loc, light_ray_unit, near_l, far_tracing, cond)
            # Lit unless the trace toward the hit converged onto a surface
            # first, or the segment lies outside the visibility bounds.
            visibility = ~mask_light | ~inside_bounding
        else:
            raise NotImplementedError(f"model.light_visibility.type '{lv.type}'")

        normal_ray_unit = loss_lib.safe_normalize(-render_output["gradient"])
        normal_x_light = torch.relu(torch.sum(normal_ray_unit * light_ray_unit, dim=-1, keepdim=True))
        return visibility, normal_x_light, inter_dist, inter_mask

    def render_light_visibility(self, center, ray_unit, near, far, outside, dists_inter,
                                cond, stratified, generator):
        """Weight-peak-ratio visibility: the largest compositing weight of
        the light ray's samples around the hit distance over the largest
        weight along the whole ray."""
        tol = int(self.para_light_visibility.get("sample_tolerance", 4))
        dists = self.sample_dists_all(center, ray_unit, near, far, cond, stratified, generator)
        points = camera.get_3D_points_from_dist(center, ray_unit, dists)
        sdfs, _, gradients, _ = self.eval_field_with_gradients(points, outside, cond, train=False)
        alphas = self.compute_neus_alphas(ray_unit, sdfs, gradients, dists,
                                          dist_far=far[..., None], cos_anneal=cond["cos_anneal"])
        weights = render.alpha_compositing_weights(alphas)[..., 0]  # [B,R,N]
        dist_index = samp.searchsorted_batched(dists[..., 0], dists_inter)  # [B,R,1]
        offsets = torch.arange(1 - tol // 2, 1 + tol // 2, device=weights.device)
        indices = torch.clamp(dist_index + offsets, 0, weights.shape[-1] - 1)
        max_around = torch.amax(torch.gather(weights, -1, indices), dim=-1, keepdim=True)
        max_total = torch.amax(weights, dim=-1, keepdim=True)
        return max_around / (max_total + 1e-12)

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------

    def forward(self, data, cond, generator: Optional[torch.Generator] = None, train: bool = True):
        """Render the pre-picked rays of each image.

        data: pose [B,3,4], intr [B,3,3], pose_light [B,3,4], ray_idx [B,R],
        idx [B].
        """
        center, ray_unit = self.picked_rays(data)
        # The light center is constant per image; broadcast it per ray.
        pts_light = camera.get_camera_center(data["pose_light"], num_pixels=1).expand_as(ray_unit)
        return self.render_rays(center, ray_unit, cond, pts_light=pts_light,
                                sample_idx=data["idx"] if self.with_appear_embed else None,
                                stratified=self.cfg_render.stratified and train,
                                generator=generator, train=train)
