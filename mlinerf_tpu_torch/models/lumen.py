"""MLI-NeRF light-conditioned model, plain ``rgb`` mode: every ray's
radiance is conditioned on its light position.

The intrinsic network modes (r_s, r_s_re, rgb_r, rgb_r_s), the background
model and light visibility are not ported yet (models/neuralangelo.py
``check_ported`` rejects configs that ask for them).
"""

from __future__ import annotations

from typing import Optional

import torch

from mlinerf_tpu_torch.config import register
from mlinerf_tpu_torch.models.fields import LumenRGB
from mlinerf_tpu_torch.models.neuralangelo import Model as AngeloModel
from mlinerf_tpu_torch.utils import camera, render
from mlinerf_tpu_torch.utils import losses as loss_lib
from mlinerf_tpu_torch.utils import sampling as samp


@register("model", "lumen")
class Model(AngeloModel):
    """Lumen model: Neuralangelo geometry with the light-conditioned head."""

    def _build_rgb(self, generator: torch.Generator):
        return LumenRGB(self.cfg_model.object.rgb, feat_dim=self.cfg_model.object.sdf.mlp.hidden_dim,
                        generator=generator)

    def render_rays(self, center, ray_unit, cond, pts_light, stratified: bool = False,
                    generator: Optional[torch.Generator] = None, train: bool = True):
        """Render rays [B,R,3] lit from ``pts_light`` [B,R,3]."""
        near, far, outside = self.get_dist_bounds(center, ray_unit)
        out_obj = self.render_rays_object_lumen(center, ray_unit, pts_light, near, far, outside,
                                                cond, stratified, generator, train)
        weights = render.alpha_compositing_weights(out_obj["alphas"])
        opacity_all = render.composite_opacity(weights)
        rgb = render.composite(out_obj["rgbs"], weights)
        if self.white_background:
            rgb = rgb + (1 - opacity_all)
        return dict(
            rgb=rgb,
            opacity=out_obj["opacity"],
            outside=outside,
            dists=out_obj["dists"],
            weights=weights,
            gradient=out_obj["gradient"],
            gradients=out_obj["gradients"],
            hessians=out_obj["hessians"],
        )

    def render_rays_object_lumen(self, center, ray_unit, pts_light, near, far, outside,
                                 cond, stratified, generator, train: bool):
        dists = self.sample_dists_all(center, ray_unit, near, far, cond, stratified, generator)
        points = camera.get_3D_points_from_dist(center, ray_unit, dists)
        sdfs, feats, gradients, hessians = self.eval_field_with_gradients(points, outside, cond, train)
        rays_unit = ray_unit[..., None, :].expand_as(points)
        normals = loss_lib.safe_normalize(gradients)
        pts_light_expand = pts_light[..., None, :].expand_as(points)
        rgbs = self.neural_rgb(points, normals, rays_unit, feats, pts_light_expand)
        alphas = self.compute_neus_alphas(ray_unit, sdfs, gradients, dists,
                                          dist_far=far[..., None], progress=cond["progress"])
        # Opacity and the composited normal are inference outputs, not ported yet.
        return dict(rgbs=rgbs, sdfs=sdfs[..., 0], dists=dists, alphas=alphas, opacity=None,
                    gradient=None, gradients=gradients, hessians=hessians)

    def forward(self, data, cond, generator: Optional[torch.Generator] = None, train: bool = True):
        """Render the pre-picked rays of each image.

        data: pose [B,3,4], intr [B,3,3], pose_light [B,3,4], ray_idx [B,R].
        """
        center, ray = camera.get_center_and_ray(data["pose"], data["intr"],
                                                self.cfg_data.train.image_size)
        center = samp.slice_by_ray_idx(center, data["ray_idx"])
        ray = samp.slice_by_ray_idx(ray, data["ray_idx"])
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        # The light center is constant per image; broadcast it per ray.
        pts_light = camera.get_camera_center(data["pose_light"], num_pixels=1).expand_as(ray_unit)
        return self.render_rays(center, ray_unit, cond, pts_light=pts_light,
                                stratified=self.cfg_render.stratified and train,
                                generator=generator, train=train)
