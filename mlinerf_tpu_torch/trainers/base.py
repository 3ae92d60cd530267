"""Training engine: device-resident data, per-step image and ray picks, the
train step (render, loss, backward, AdamW update, gradient norm), the
parameter average (EMA), partial training and the cross-stage warm start, a
plain Python train loop with JSONL logging, the NaN kill-switch, validation
and checkpoint triggers, the occupancy grid's upkeep, and the full-image
renderer behind validation and inference.

The training split lives on the device as stacked tensors; each step picks
its image and rays there with an explicit ``torch.Generator``, so the host
only enqueues work and reads the loss at logging steps. A full image renders
in a host loop over ``rand_rays_val``-ray chunks without autograd; only the
per-ray outputs of each chunk are kept, so memory is bounded by the chunk.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlinerf_tpu_torch.config import resolve
from mlinerf_tpu_torch.ops import occupancy as occ_ops
from mlinerf_tpu_torch.trainers import optim as optim_lib
from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer, nonstrict_restore
from mlinerf_tpu_torch.utils import camera
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.misc import get_device, require_ported


class MetricsLogger:
    """Appends one JSON object per logging step to ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def log_scalars(self, scalars: Dict[str, float], step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), **{k: float(v) for k, v in scalars.items()}}) + "\n")


class BaseTrainer:
    """Generic trainer: subclasses provide ``compute_loss`` and ``make_cond``."""

    def __init__(self, cfg, is_inference: bool = False, seed: int = 0, logdir: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.is_inference = is_inference
        self.seed = seed
        self.device = get_device(device)
        self.logdir = logdir or cfg.get("logdir") or "logs/default"
        tcfg = cfg.trainer
        # Mixed precision: the models' MLPs compute in bf16 (parameters stay
        # float32); a model that does not carry it raises.
        self.compute_dtype = torch.bfloat16 if tcfg.get("amp_config", {}).get("enabled") else torch.float32
        require_ported(int(tcfg.get("grad_accum_iter", 1) or 1) == 1, "trainer.grad_accum_iter")
        require_ported((tcfg.get("init", {}) or {}).get("type", "none") in (None, "none"), "trainer.init.type")

        # Model: initialized on the CPU from the seed, then moved, so the same
        # seed gives the same weights on every device.
        model_cls = resolve("model", cfg.model.type)
        self.model = model_cls(cfg.model, cfg.data, generator=torch.Generator().manual_seed(seed),
                               compute_dtype=self.compute_dtype)
        self.model.to(self.device)
        named = list(self.model.named_parameters())
        self.num_params = sum(p.numel() for _, p in named)
        print(f"[model] {cfg.model.type}: {self.num_params / 1e6:.2f}M parameters")
        # Partial training: the optimizer holds the matching parameters only;
        # the others get no gradient, so the backward stops at them.
        self.partial_keywords = list(cfg.optim.get("partial_training") or tcfg.get("partial_grad") or [])
        trainable = named
        if self.partial_keywords:
            trainable, frozen = optim_lib.partition_params(named, self.partial_keywords)
            for _, p in frozen:
                p.requires_grad_(False)
            print(f"[optim] partial training on {self.partial_keywords}: "
                  f"{sum(p.numel() for _, p in trainable) / 1e6:.2f}M trainable")
        self.trainable_names = [n for n, _ in trainable]
        # Indices into the optimizer's list.
        self.table_param_idx = [i for i, n in enumerate(self.trainable_names) if ".hash_table." in n]
        self.optimizer, self.lr_fn = optim_lib.make_optimizer(cfg.optim, [p for _, p in trainable],
                                                              names=self.trainable_names)

        # Image/ray picks and stratified jitter draw from this generator.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.current_iteration = 0
        self.current_epoch = 0
        self._ckpt_prev_epoch = 0
        self.checkpointer = Checkpointer(cfg, self.logdir)
        self.logger = MetricsLogger(self.logdir)
        self.weights = {k: float(v) for k, v in tcfg.get("loss_weight", {}).items() if v is not None}
        self.warm_start_report = self._maybe_warm_start(cfg)
        # EMA: a second copy of the model whose parameters are the average,
        # updated after every optimizer step; evaluation renders from it. It
        # is taken after the warm start, so it starts from the warm-started
        # weights (the JAX package copies the random init, then warm-starts
        # the params alone).
        self.ema_beta = float(tcfg.ema_config.beta) if tcfg.ema_config.enabled else None
        self.ema_model = None
        if self.ema_beta is not None:
            self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        # The occupancy grid of the coarse samples (model.render.occupancy),
        # refreshed by train() every update_every steps.
        occ_cfg = (cfg.model.get("render") or {}).get("occupancy") or {}
        self.occupancy_cfg = occ_cfg if occ_cfg.get("enabled") else None
        self.occupancy_grid = None
        self._occupancy_iter = None

    def _maybe_warm_start(self, cfg) -> Optional[Dict[str, list]]:
        """The cross-stage warm start (``model.use_pre_trained``): copy every
        parameter of that checkpoint whose name and shape match. Returns the
        missing / unexpected / mismatched report, or None."""
        upt = cfg.model.get("use_pre_trained")
        if not upt:
            return None
        payload = Checkpointer.load_file(upt.pt_filename)
        params, report = nonstrict_restore(self.model.state_dict(), payload["state"]["params"])
        self.model.load_state_dict(params)
        print(f"[warm-start] loaded {upt.pt_filename}")
        for key in ("missing", "unexpected"):
            names = report[key]
            print(f"  {key} keys: {names[:8]}{'...' if len(names) > 8 else ''}")
        return report

    # ------------------------------------------------------------------
    # Schedule and loss hooks (overridden per project)
    # ------------------------------------------------------------------

    def make_cond(self, iteration: int) -> Dict[str, Any]:
        return {"progress": np.float32(iteration) / np.float32(self.cfg.max_iter)}

    def static_max_levels_for(self, iteration: int) -> Optional[int]:
        """Hash levels the encoder gathers at ``iteration`` (None = all)."""
        return None

    def loss_weights_at(self, iteration: int, cond) -> Dict[str, float]:
        """Loss weights, float32-rounded Python floats."""
        return {k: float(np.float32(v)) for k, v in self.weights.items()}

    def compute_loss(self, output, batch, mode: str):
        raise NotImplementedError

    def _needs_light(self) -> bool:
        return False

    def pixel_array_keys(self):
        """(array_key, batch_key) pairs gathered per picked ray."""
        return [("images", "image_sampled")]

    def num_rand_rays(self) -> int:
        return self.cfg.model.render.rand_rays

    def num_val_rays(self) -> int:
        node = self.cfg.model.render if "render" in self.cfg.model else self.cfg.model
        return node.get("rand_rays_val") or 20000

    # ------------------------------------------------------------------
    # Batches
    # ------------------------------------------------------------------

    def sample_batch(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pick ``batch_size`` images and ``rand_rays`` distinct pixels of each."""
        B = self.cfg.data.train.batch_size
        H, W = self.cfg.data.train.image_size
        img_idx = torch.randint(0, arrays["pose"].shape[0], (B,), generator=self.generator,
                                device=self.device)
        ray_idx = samp.random_ray_indices(self.generator, B, H * W, self.num_rand_rays(),
                                          device=self.device)
        return self.gather_batch(arrays, img_idx, ray_idx)

    def gather_batch(self, arrays: Dict[str, torch.Tensor], img_idx: torch.Tensor,
                     ray_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch of images ``img_idx`` [B] and pixels ``ray_idx`` [B,R]."""
        B = img_idx.shape[0]
        H, W = self.cfg.data.train.image_size
        batch = {"idx": img_idx, "ray_idx": ray_idx}
        for key in ("pose", "intr", "pose_light"):
            if key in arrays:
                batch[key] = arrays[key].index_select(0, img_idx)
        for key, out_key in self.pixel_array_keys():
            if key in arrays:
                flat = arrays[key].index_select(0, img_idx).reshape(B, H * W, -1)
                vals = samp.slice_by_ray_idx(flat, ray_idx)
                if vals.dtype == torch.uint8:  # 8-bit images decode after the gather
                    vals = _uint8_to_unit(vals)
                batch[out_key] = vals
        return batch

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One step on ``batch``: render, loss, backward, AdamW update.
        Returns device tensors: total, losses, metrics, grad norms."""
        it = self.current_iteration
        cond = self.make_cond(it)
        cond["max_levels"] = self.static_max_levels_for(it)
        if self.occupancy_grid is not None:
            cond["occupancy_grid"] = self.occupancy_grid
        weights = self.loss_weights_at(it, cond)
        output = self.model(batch, cond, generator=self.generator, train=True)
        loss_dict, metric_dict = self.compute_loss(output, batch, mode="train")
        total = torch.zeros((), device=self.device)
        for key, value in loss_dict.items():
            if key in weights:
                total = total + weights[key] * value
        params = self.optimizer.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # A level the encoder skipped has no gradient; optax sees zeros there.
        # With partial training only the trainable parameters are here, and
        # the norms are over their gradients.
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        info = dict(
            total=total.detach(),
            losses={k: v.detach() for k, v in loss_dict.items()},
            metrics={k: v.detach() for k, v in metric_dict.items()},
            grad_norm=optim_lib.global_norm(grads),
            table_grad_norm=optim_lib.global_norm([grads[i] for i in self.table_param_idx]),
        )
        self.optimizer.step(grads)
        if self.ema_model is not None:
            optim_lib.ema_update(list(self.ema_model.parameters()), list(self.model.parameters()), self.ema_beta)
        self.current_iteration = it + 1
        return info

    # ------------------------------------------------------------------
    # Train loop
    # ------------------------------------------------------------------

    def train(self, train_arrays: Dict[str, np.ndarray], val_dataset=None, show_progress: bool = False):
        """Train from the current iteration to ``max_iter``; logs every
        ``logging_iter`` steps and aborts on a non-finite loss there,
        validates on ``val_dataset`` every ``validation_iter`` steps and
        saves checkpoints as ``cfg.checkpoint`` says."""
        cfg = self.cfg
        arrays = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in train_arrays.items()}
        if self._needs_light() and "pose_light" not in arrays:
            raise KeyError("this trainer needs per-image light poses ('pose_light')")
        log_iter = min(cfg.logging_iter, cfg.get("wandb_scalar_iter", cfg.logging_iter))
        val_iter = cfg.get("validation_iter", 10**12)
        images_per_epoch = max(arrays["pose"].shape[0], 1)
        rays_per_step = self.num_rand_rays() * cfg.data.train.batch_size
        info = None
        t_window, iters_in_window = time.perf_counter(), 0
        while self.current_iteration < cfg.max_iter:
            self.maybe_update_occupancy()
            info = self.train_step(self.sample_batch(arrays))
            it = self.current_iteration
            self.current_epoch = it * cfg.data.train.batch_size // images_per_epoch
            iters_in_window += 1
            if it % log_iter == 0 or it == cfg.max_iter:
                self._log_step(info, it, rays_per_step, t_window, iters_in_window, show_progress)
                t_window, iters_in_window = time.perf_counter(), 0
            if val_dataset is not None and it % val_iter == 0:
                self.validate(val_dataset, step=it)
            self._checkpoint_triggers(it)
        return info

    @torch.no_grad()
    def maybe_update_occupancy(self):
        """Refresh the occupancy grid from the SDF at the grid's cell
        centres (one field evaluation at the current iteration's schedule,
        every hash level) when it is due: at the first step and every
        ``update_every`` steps after the last refresh."""
        occ = self.occupancy_cfg
        it = self.current_iteration
        if occ is None or (self._occupancy_iter is not None
                           and it - self._occupancy_iter < int(occ.get("update_every", 256))):
            return
        res = int(occ.get("resolution", 64))
        hg = self.cfg.model.object.sdf.encoding.hashgrid
        rmin, rmax = float(hg.range[0]), float(hg.range[1])
        coords = torch.from_numpy(occ_ops.grid_coordinates(res, rmin, rmax)).to(self.device)[None]
        sdf = self.model.sdf_only(coords, self.make_cond(it))[0, :, 0]
        self.occupancy_grid = occ_ops.occupancy_from_sdf(sdf, res, rmin, rmax, float(occ.get("band_cells", 3.0)))
        self._occupancy_iter = it

    def _log_step(self, info, it: int, rays_per_step: int, t_window: float, iters_in_window: int,
                  show_progress: bool):
        total = float(info["total"])  # waits for the device
        if not np.isfinite(total):
            raise FloatingPointError(f"Training loss is {total} at iteration {it} — aborting "
                                     "(NaN/Inf kill-switch).")
        dt = (time.perf_counter() - t_window) / iters_in_window
        scalars = {
            "train/total_loss": total,
            "train/iter_time": dt,
            "train/rays_per_sec": rays_per_step / dt,
            "optim/lr": float(self.lr_fn(it)),
            "train/grad_norm": float(info["grad_norm"]),
            "train/table_grad_norm": float(info["table_grad_norm"]),
            **{f"train/loss/{k}": float(v) for k, v in info["losses"].items()},
            **{f"train/{k}": float(v) for k, v in info["metrics"].items()},
        }
        self.logger.log_scalars(scalars, it)
        if show_progress:
            msg = ", ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in scalars.items()
                            if "loss" in k or "psnr" in k)
            print(f"[iter {it}/{self.cfg.max_iter}] {msg} ({dt * 1000:.1f} ms/it)", flush=True)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_triggers(self, iteration: int):
        ck = self.cfg.checkpoint
        save = iteration % ck.save_iter == 0
        save_epoch = ck.get("save_epoch")
        if save_epoch:
            # Crossing a multiple of save_epoch, however far the epoch moved.
            if self.current_epoch // save_epoch > self._ckpt_prev_epoch // save_epoch:
                save = True
            self._ckpt_prev_epoch = self.current_epoch
        period = self.checkpointer.reached_checkpointing_period()
        latest = iteration % ck.save_latest_iter == 0 or period
        if save or latest:
            self.save_checkpoint(iteration, latest=latest)

    def save_checkpoint(self, iteration: Optional[int] = None, latest: bool = False):
        iteration = self.current_iteration if iteration is None else int(iteration)
        state = dict(params=_host_state(self.model), opt_state=self.optimizer.state_dict(),
                     ema_params=_host_state(self.ema_model) if self.ema_model is not None else None,
                     iteration=iteration)
        self.checkpointer.save(state, self.current_epoch, iteration, latest=latest)

    def load_checkpoint(self, checkpoint_path: Optional[str] = None, resume: bool = False,
                        load_opt: bool = True) -> bool:
        """Load params (and, resuming, the optimizer state) from
        ``checkpoint_path`` or the latest pointer; with EMA on, the average
        too (a checkpoint without one restarts it from the loaded params).
        Inference and a resume take the checkpoint's iteration: the
        coarse-to-fine level mask, the normal epsilon and the NeuS cosine
        anneal derive from it, so a render of a trained model runs at its
        trained iteration. Returns whether a checkpoint was found."""
        payload, path = self.checkpointer.load(checkpoint_path)
        if payload is None:
            print("[checkpoint] training from scratch")
            return False
        st = payload["state"]
        self.model.load_state_dict(st["params"])
        if self.ema_model is not None:
            self.ema_model.load_state_dict(st.get("ema_params") or st["params"])
        if st.get("iteration") is not None and (self.is_inference or resume):
            self.current_iteration = int(st["iteration"])
        if resume and load_opt and st.get("opt_state") is not None:
            self.optimizer.load_state_dict(st["opt_state"])
        print(f"[checkpoint] loaded {path} (iteration {st.get('iteration')})")
        return True

    # ------------------------------------------------------------------
    # Full-image rendering, inference outputs and validation
    # ------------------------------------------------------------------

    def eval_model(self):
        """The model every evaluation renders from: the EMA copy where EMA
        is on, else the trained model."""
        return self.ema_model if self.ema_model is not None else self.model

    def render_image(self, data: Dict[str, np.ndarray], image_size, num_rays_chunk: Optional[int] = None,
                     render_kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, np.ndarray]:
        """Render full images: pose [B,3,4], intr [B,3,3] (and pose_light
        [B,3,4]) in ``data``. Returns every per-ray output [B,H*W,K] as
        numpy, from :meth:`eval_model`; ``render_kwargs`` go to its
        ``render_chunk``."""
        H, W = image_size
        total = H * W
        num_rays_chunk = min(int(num_rays_chunk or self.num_val_rays()), total)
        it = self.current_iteration
        cond = self.make_cond(it)
        cond["max_levels"] = self.static_max_levels_for(it)
        pose = torch.as_tensor(np.asarray(data["pose"]), device=self.device)
        intr = torch.as_tensor(np.asarray(data["intr"]), device=self.device)
        center, ray = camera.get_center_and_ray(pose, intr, (H, W))
        pts_light = None
        if "pose_light" in data and self._needs_light():
            pose_light = torch.as_tensor(np.asarray(data["pose_light"]), device=self.device)
            pts_light = camera.get_camera_center(pose_light, num_pixels=1).expand_as(ray)
        kwargs = dict(render_kwargs or {})
        model = self.eval_model()
        chunks = []
        with torch.no_grad():
            for c0 in range(0, total, num_rays_chunk):
                sl = slice(c0, c0 + num_rays_chunk)
                if pts_light is not None:
                    kwargs["pts_light"] = pts_light[:, sl]
                out = model.render_chunk(center[:, sl], ray[:, sl], cond, **kwargs)
                rays = center[:, sl].shape[1]
                # Per-ray outputs only: the per-sample ones would hold the
                # whole image's samples.
                chunks.append({k: v for k, v in out.items()
                               if isinstance(v, torch.Tensor) and v.ndim == 3 and v.shape[1] == rays})
        return {k: torch.cat([c[k] for c in chunks], dim=1).cpu().numpy() for k in chunks[0]}

    def inference_outputs(self, data, image_size) -> Dict[str, np.ndarray]:
        """Full inference pass: ``*_map`` images [B,H,W,C]."""
        return outputs_to_maps(self.render_image(data, image_size), data, image_size)

    def validate(self, val_dataset, step: int, max_samples: int = 4) -> float:
        """Render up to ``max_samples`` validation images and log their mean
        PSNR (``val/psnr``), with ``val/psnr_ref`` and ``val/psnr_sha``
        where the dataset carries ground-truth intrinsics and the model
        renders them."""
        image_size = self.cfg.data.val.image_size
        psnrs = []
        comp_psnrs: Dict[str, list] = {}

        def _psnr(a, b):
            return -10 * np.log10(np.mean((a - b) ** 2) + 1e-12)

        for i in range(min(len(val_dataset), max_samples)):
            sample = val_dataset[i]
            data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
            maps = self.inference_outputs(data, image_size)
            psnrs.append(_psnr(maps["rgb_map"][0], np.asarray(sample["image"])))
            # Shading is scored gamma-corrected (1/2.2), as the reference's
            # metrics do.
            if "Ref" in sample and "o_r_map" in maps:
                comp_psnrs.setdefault("psnr_ref", []).append(_psnr(maps["o_r_map"][0], np.asarray(sample["Ref"])))
            if "Sha" in sample and "o_s_map" in maps:
                sha_pred = np.clip(maps["o_s_map"][0], 0, 1) ** (1 / 2.2)
                sha_gt = np.clip(np.asarray(sample["Sha"]), 0, 1) ** (1 / 2.2)
                if sha_gt.ndim == 2:
                    sha_gt = sha_gt[..., None]
                if sha_pred.shape[-1] != sha_gt.shape[-1]:
                    sha_pred = sha_pred.mean(-1, keepdims=True)
                    sha_gt = sha_gt.mean(-1, keepdims=True)
                comp_psnrs.setdefault("psnr_sha", []).append(_psnr(sha_pred, sha_gt))
        scalars = {"val/psnr": float(np.mean(psnrs))}
        scalars.update({f"val/{k}": float(np.mean(v)) for k, v in comp_psnrs.items()})
        self.logger.log_scalars(scalars, step)
        comp_msg = "".join(f", {k.split('_')[1]} {np.mean(v):.2f}" for k, v in sorted(comp_psnrs.items()))
        print(f"[val @ {step}] PSNR = {np.mean(psnrs):.2f} dB{comp_msg}", flush=True)
        return scalars["val/psnr"]


_UNIT_TABLES: Dict[torch.device, torch.Tensor] = {}


def _uint8_to_unit(vals: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 ``v / 255``, the same bits on every device: a
    256-entry table divided on the host (CUDA divides a tensor by a scalar
    as a multiply by its reciprocal, which rounds about half of the 256
    values differently)."""
    table = _UNIT_TABLES.get(vals.device)
    if table is None:
        table = _UNIT_TABLES[vals.device] = (torch.arange(256, dtype=torch.float32) / 255.0).to(vals.device)
    return table[vals.long()]


def _host_state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


_FLOAT_MAP_KEYS = ("opacity", "depth", "o_r", "o_s", "o_re")
_CAST_MAP_KEYS = ("visibility", "normal_x_light", "pseudo_shading", "inter_dist", "inter_mask")


def outputs_to_maps(out: Dict[str, np.ndarray], data, image_size) -> Dict[str, np.ndarray]:
    """Per-ray outputs [B,H*W,K] as ``*_map`` images [B,H,W,K]. The normal
    map is in camera axes: ``-gradient @ rot^T``; the boolean maps become
    float32."""
    H, W = image_size

    def to_map(x):
        return x.reshape(x.shape[0], H, W, -1)

    maps = {"rgb_map": to_map(out["rgb"])}
    if "gradient" in out:
        rot = np.asarray(data["pose"])[..., :3, :3]
        maps["normal_map"] = to_map(-out["gradient"] @ np.swapaxes(rot, -1, -2))
    for key in _FLOAT_MAP_KEYS:
        if key in out:
            maps[key + "_map"] = to_map(out[key])
    for key in _CAST_MAP_KEYS:
        if key in out:
            maps[key + "_map"] = to_map(out[key].astype(np.float32))
    return maps
