"""Cross-light pseudo labels for stage b: ``python -m
mlinerf_tpu_torch.pipelines.pseudo_label --workdir <dir> --setting
pair|unpair|single_light [--save_pngs] [--device cuda|cpu]``.

Reads ``<workdir>/results_all.npz`` (the per-(camera, light) renders of
``test --inference_mode *lights*``) and writes
``<workdir>_pseudo_label/pseudo_label_all.npz`` in the JAX package's layout:
per camera a pseudo reflectance [H,W,3], per light a gamma-corrected pseudo
shading and a visibility certainty [H,W,1] each. Runs on CUDA unless
``--device cpu`` is given.

Per camera:
  1. morphology: erode the visibility; pseudo shading = normal . light x
     the eroded visibility (x the camera-hit mask for ``unpair``); the
     multi-scale edge weight of the visibility is its certainty;
  2. k-means over each pixel's colours under the L lights, in opponent
     chroma (brightness-invariant); reflectance = image / shading^(1/2.2),
     averaged over the lights of the pixel's majority cluster whose
     shading is above 0.6 of the brightest such light's;
  3. fill: pixels with no lit light (and, outside ``pair``, off the
     surface hit) take the reflectance of the nearest valid pixel in
     (position x 4, normal, the K cluster centres) feature space.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlinerf_tpu_torch.ops import kmeans as kmeans_ops
from mlinerf_tpu_torch.ops import knn as knn_ops
from mlinerf_tpu_torch.ops import morphology as morph
from mlinerf_tpu_torch.pipelines.label_store import load_results_all, save_results_all
from mlinerf_tpu_torch.utils.image_io import save_image
from mlinerf_tpu_torch.utils.misc import get_device

PARAMS = {
    "unpair": dict(kernel_erosion_visibility=7, edge_step_visibility_certainty=7,
                   kmeans_num_clusters=2, shading_threshold=0.0, shading_threshold_wrt_max=0.6,
                   gamma_correlation_factor=2.2, fill_search_points=10),
    "pair": dict(kernel_erosion_visibility=7, edge_step_visibility_certainty=7,
                 kmeans_num_clusters=3, shading_threshold=0.0, shading_threshold_wrt_max=0.6,
                 gamma_correlation_factor=2.2, fill_search_points=1000),
    "single_light": dict(kernel_erosion_visibility=3, edge_step_visibility_certainty=7,
                         kmeans_num_clusters=1, shading_threshold=0.0, shading_threshold_wrt_max=0.6,
                         gamma_correlation_factor=2.2, fill_search_points=1000),
}


def rgb2opp(imgs: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3] -> opponent chroma (o1, o2) [..., 2]."""
    r, g, b = imgs[..., 0], imgs[..., 1], imgs[..., 2]
    o1 = (r - g) / math.sqrt(2)
    o2 = (r + g - 2.0 * b) / math.sqrt(6)
    return torch.stack([o1, o2], dim=-1)


def find_best_ref(mask_shading, kmeans_label, num_clusters: int, pseudo_shadings,
                  shading_threshold_wrt_max: float, ref):
    """Mean reflectance over the lights in each pixel's majority cluster
    whose shading exceeds ``shading_threshold_wrt_max`` of the brightest
    such light's. A light with no valid shading falls in an extra bin that
    is never the majority.

    mask_shading, pseudo_shadings, kmeans_label [L,H,W]; ref [L,H,W,3].
    Returns [H,W,3]."""
    label = torch.where(mask_shading, kmeans_label.long(), num_clusters)
    counts = torch.stack([(label == i).sum(dim=0) for i in range(num_clusters)])  # [K,H,W]
    is_majority = counts == torch.amax(counts, dim=0)[None]
    padded = torch.cat([is_majority, torch.zeros_like(is_majority[:1])], dim=0)  # [K+1,H,W]
    in_majority = torch.gather(padded, 0, label)  # [L,H,W]
    shading_max = torch.amax(pseudo_shadings * in_majority.to(pseudo_shadings.dtype), dim=0)
    final_mask = in_majority & (pseudo_shadings > shading_threshold_wrt_max * shading_max[None])
    summed = torch.sum(torch.where(final_mask[..., None], ref, 0.0), dim=0)
    n = torch.clamp(torch.sum(final_mask, dim=0), min=1)[..., None]
    return summed / n


def fill_holes_nn(ref, normal, color_feature, mask):
    """Fill the invalid pixels of ``ref`` [H,W,3] (``mask`` [H,W] False)
    from the nearest valid pixel in (position x 4, unit normal, colour)
    feature space. ``normal`` [H,W,3]; ``color_feature`` [K,2,H,W] (every
    cluster centre, 2K features per pixel) or [H,W,C]."""
    H, W = ref.shape[:2]
    weight_position, weight_normal, weight_color = 4.0, 1.0, 1.0
    ys, xs = torch.meshgrid(torch.arange(H, device=ref.device), torch.arange(W, device=ref.device),
                            indexing="ij")
    pos = torch.stack([ys, xs], dim=-1).float()
    pos = pos / torch.amax(pos) * weight_position
    n = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-10) * weight_normal
    if color_feature.ndim == 4:
        cf = torch.movedim(color_feature, (0, 1), (-2, -1)).reshape(H, W, -1) * weight_color
    else:
        cf = color_feature * weight_color
    feats = torch.cat([pos, n, cf], dim=-1).reshape(H * W, -1)
    filled = knn_ops.masked_nearest_fill(ref.reshape(H * W, -1), feats, mask.reshape(-1))
    return filled.reshape(H, W, -1)


def generate_pseudo_labels(results_all: Dict[str, Any], setting: str = "pair",
                           output_path: Optional[str] = None, save_pngs: bool = False,
                           params: Optional[Dict] = None, device=None,
                           first_index: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The pipeline over a ``results_all`` nested dict (maps [1,H,W,C] per
    camera and light). ``first_index`` [H*W] gives each pixel's first
    k-means centre (the same for every camera, as the JAX package's draws
    are); without it they come from ``kmeans.first_indices``.

    Returns {cam: {'pseudo_reflectance': [H,W,3], light:
    {'pseudo_shading_gamma': [H,W,1], 'visibility_certainty': [H,W,1]}}}
    as numpy, and writes ``<output_path>/pseudo_label_all.npz`` when
    ``output_path`` is given."""
    para = dict(PARAMS[setting])
    para.update(params or {})
    device = get_device(device)
    K = para["kmeans_num_clusters"]
    inv_gamma = 1.0 / para["gamma_correlation_factor"]

    def as_tensor(x):
        return torch.as_tensor(np.asarray(x)[0], device=device)  # [H,W,C]

    out_all: Dict[str, Any] = {}
    for cam, cam_data in results_all.items():
        cam = str(cam)
        out_all[cam] = {}
        imgs, shadings = [], []
        use_key = "rgb_target" if all("rgb_target" in d for d in cam_data.values()) else "rgb_render"
        for light, d in cam_data.items():
            vis = as_tensor(d["visibility"])[..., 0]
            shading = as_tensor(d["normal_x_light"])[..., 0] * morph.erosion(vis, para["kernel_erosion_visibility"])
            if setting == "unpair":
                shading = shading * as_tensor(d["inter_mask"])[..., 0]
            certainty = morph.edge_weight(vis, para["edge_step_visibility_certainty"])
            s_gamma = torch.pow(shading, inv_gamma)
            out_all[cam][str(light)] = {
                "visibility_certainty": certainty[..., None].cpu().numpy(),
                "pseudo_shading_gamma": s_gamma[..., None].cpu().numpy(),
            }
            if save_pngs and output_path:
                save_image(os.path.join(output_path, f"{cam}_{light}_visibility_certainty.png"),
                           out_all[cam][str(light)]["visibility_certainty"])
                save_image(os.path.join(output_path, f"{cam}_{light}_pseudo_shading_gamma.png"),
                           out_all[cam][str(light)]["pseudo_shading_gamma"])
            imgs.append(as_tensor(d[use_key]))
            shadings.append(shading)
        imgs = torch.stack(imgs)  # [L,H,W,3]
        L, H, W = imgs.shape[:3]

        # k-means over each pixel's colours under the L lights.
        vectors = rgb2opp(imgs).reshape(L, H * W, 2).transpose(0, 1)  # [P,L,2]
        fi = None if first_index is None else first_index.to(device)
        labels, centers = kmeans_ops.kmeans_per_pixel(vectors, K, first_index=fi)
        kmeans_label = labels.transpose(0, 1).reshape(L, H, W)
        kmeans_center = torch.movedim(centers, 0, -1).reshape(K, 2, H, W)

        # Reflectance from the confident shadings.
        pseudo_shadings = torch.stack(shadings)  # [L,H,W]
        mask_shading = pseudo_shadings > para["shading_threshold"]
        ref = imgs / torch.clamp(torch.pow(pseudo_shadings, inv_gamma)[..., None], min=1e-6)
        average_ref = find_best_ref(mask_shading, kmeans_label, K, pseudo_shadings,
                                    para["shading_threshold_wrt_max"], ref)

        # Fill the holes.
        first = cam_data[next(iter(cam_data))]
        mask_valid = torch.any(mask_shading, dim=0)
        if setting != "pair":
            mask_valid = mask_valid | ~(as_tensor(first["inter_mask"])[..., 0] > 0)
        filled = fill_holes_nn(average_ref, as_tensor(first["normal"]), kmeans_center, mask_valid)
        out_all[cam]["pseudo_reflectance"] = filled.cpu().numpy()
        if save_pngs and output_path:
            save_image(os.path.join(output_path, f"{cam}_average_ref.png"), average_ref.cpu().numpy())
            save_image(os.path.join(output_path, f"{cam}_pseudo_reflectance.png"), out_all[cam]["pseudo_reflectance"])
    if output_path:
        save_results_all(out_all, os.path.join(output_path, "pseudo_label_all"))
    return out_all


def main(argv=None):
    parser = argparse.ArgumentParser(description="pseudo label (PyTorch port)")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--setting", choices=sorted(PARAMS), required=True)
    parser.add_argument("--save_pngs", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args = parser.parse_args(argv)
    device = get_device(args.device)
    results_all = load_results_all(os.path.join(args.workdir, "results_all"))
    output_path = args.workdir.rstrip("/") + "_pseudo_label"
    os.makedirs(output_path, exist_ok=True)
    generate_pseudo_labels(results_all, args.setting, output_path, save_pngs=args.save_pngs, device=device)
    print(f"Wrote {output_path}/pseudo_label_all.npz", flush=True)
    return output_path


if __name__ == "__main__":
    main()
