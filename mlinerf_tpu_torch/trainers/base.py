"""Training engine: device-resident data, per-step image and ray picks, the
train step (render, loss, backward, AdamW update, gradient norm), the
parameter average (EMA), partial training and the cross-stage warm start, a
plain Python train loop with JSONL logging, the NaN kill-switch, validation
and checkpoint triggers, the occupancy grid's upkeep, the full-image
renderer behind validation and inference, and data-parallel training over
ranks (``parallel/distributed.py``).

The training split lives on the device as stacked tensors; each step picks
its image and rays there with an explicit ``torch.Generator``, so the host
only enqueues work. Training runs in the JAX package's dispatch windows
(``trainers/windows.py``): ``n`` steps between two host reads, sized from the
logging, validation and checkpoint cadences and ``trainer.steps_per_dispatch``;
the logs read each window's mean losses, metrics and gradient norms, which
the steps add up on the device. On a CUDA device each step of a window is a
replay of a CUDA graph of the fixed-shape step, which reads its row of the
window's schedule table (learning rate, bias corrections, loss weights, the
NeuS anneal) through a device step index. A full image renders in
fixed-size ``rand_rays_val``-ray chunks without autograd (the last one padded
and trimmed), in windows of chunks with one copy to the host each; on a CUDA
device each chunk is a graph replay. Only the per-ray outputs of each chunk
are kept, so memory is bounded by the window.

Across ranks (one process per GPU), every rank draws the global batch from
a pick generator seeded alike on every rank and keeps its slice of the rays;
the stratified jitter comes from a generator of its own. The gradients are
combined as ``runtime.grad_psum`` and ``runtime.shard_tables`` say (see
``DataParallel``); rank 0 alone writes logs, images and checkpoints, and
validates while the others wait. On NCCL each rank replays the step's CUDA
graph with the collectives inside, as on one process; gloo ranks run eager
steps (``pdist.captures_collectives``). One process is the step as it was:
one generator, no collective.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import signal
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mlinerf_tpu_torch.bridge import opt_state_from_jax
from mlinerf_tpu_torch.config import resolve
from mlinerf_tpu_torch.models.mlp import reinit_dense_weights
from mlinerf_tpu_torch.ops import occupancy as occ_ops
from mlinerf_tpu_torch.parallel import distributed as pdist
from mlinerf_tpu_torch.trainers import optim as optim_lib
from mlinerf_tpu_torch.trainers import windows
from mlinerf_tpu_torch.trainers.checkpoint import Checkpointer, nonstrict_restore
from mlinerf_tpu_torch.utils import camera
from mlinerf_tpu_torch.utils import sampling as samp
from mlinerf_tpu_torch.utils.console import get_heatmap
from mlinerf_tpu_torch.utils.image_io import save_image
from mlinerf_tpu_torch.utils.misc import get_device


class MetricsLogger:
    """Appends one JSON object per logging step to ``<logdir>/metrics.jsonl``,
    writes validation images under ``<logdir>/images/<step:09d>/``, and feeds
    wandb and TensorBoard where they are asked for and import.

    wandb resume: the run id persists in ``<logdir>/wandb_id.txt``, so a
    resumed training continues the same run. ``enabled=False`` (every rank
    but rank 0) keeps the object whole but writes nothing."""

    def __init__(self, logdir: str, use_wandb: bool = False, wandb_name: Optional[str] = None,
                 use_tensorboard: bool = False, enabled: bool = True):
        self.enabled = enabled
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self.wandb = None
        self.tb = None
        if use_wandb and enabled:
            try:
                import wandb

                wandb.init(project="mlinerf_tpu", name=wandb_name, dir=logdir, id=self._persistent_wandb_id(wandb),
                           resume="allow")
                self.wandb = wandb
            except Exception as exc:  # a missing package or a failed login: keep the JSONL sink
                print(f"[logger] wandb unavailable ({exc}); falling back to JSONL only")
        if use_tensorboard and enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=os.path.join(logdir, "tensorboard"))
            except Exception as exc:  # the tensorboard package missing or broken
                print(f"[logger] tensorboard unavailable ({exc})")

    def _persistent_wandb_id(self, wandb) -> str:
        """Read or mint the run id stored next to the checkpoints."""
        id_path = os.path.join(self.logdir, "wandb_id.txt")
        if os.path.exists(id_path):
            with open(id_path) as f:
                return f.read().strip()
        run_id = wandb.util.generate_id()
        with open(id_path, "w") as f:
            f.write(run_id)
        return run_id

    def log_scalars(self, scalars: Dict[str, float], step: int):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), **{k: float(v) for k, v in scalars.items()}}) + "\n")
        if self.wandb:
            self.wandb.log(scalars, step=step)
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), global_step=step)
            self.tb.flush()

    def log_images(self, images: Dict[str, np.ndarray], step: int):
        """Each image ([H,W,3] in [0, 1], or a single-channel map, which is
        colorized) as ``<key with / as _>.png``."""
        if not self.enabled:
            return
        img_dir = os.path.join(self.logdir, "images", f"{step:09d}")
        os.makedirs(img_dir, exist_ok=True)
        for key, img in images.items():
            arr = np.asarray(img)
            if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 1):
                arr = get_heatmap(arr[..., 0] if arr.ndim == 3 else arr)
            save_image(os.path.join(img_dir, key.replace("/", "_") + ".png"), arr)
        if self.wandb:
            self.wandb.log({k: self.wandb.Image(np.asarray(v)) for k, v in images.items()}, step=step)
        if self.tb:
            for k, v in images.items():
                self.tb.add_image(k, np.clip(np.asarray(v), 0, 1), global_step=step, dataformats="HWC")
            self.tb.flush()


class Watchdog:
    """Stall detector: SIGALRM raises ``TimeoutError`` when no ``reset``
    came for ``timeout_period`` seconds (off at 9999999 and above, and where
    the platform has no SIGALRM)."""

    def __init__(self, timeout_period: int):
        self.timeout_period = int(timeout_period)
        self.enabled = self.timeout_period < 9999999 and hasattr(signal, "SIGALRM")
        if self.enabled:
            signal.signal(signal.SIGALRM, self._handler)

    def _handler(self, signum, frame):
        raise TimeoutError(f"Training stalled for {self.timeout_period}s — aborting.")

    def reset(self):
        if self.enabled:
            signal.alarm(self.timeout_period)

    def disarm(self):
        if self.enabled:
            signal.alarm(0)


class PhaseTimer:
    """Host wall time per train step: ``time_iteration`` is a running mean
    over the last 100 steps."""

    def __init__(self):
        self.time_iteration = 0.0
        self._iter_start = time.time()
        self._count = 0

    def start_iteration(self):
        self._iter_start = time.time()

    def end_iteration(self):
        dt = time.time() - self._iter_start
        self._count += 1
        self.time_iteration += (dt - self.time_iteration) / min(self._count, 100)


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
        # Ranks: one process per GPU under torch.distributed (runtime.mesh
        # "rays" and "batch" both shard the ray axis; "none" is one process).
        rt = cfg.get("runtime") or {}
        self.world = pdist.world_size() if pdist.mesh_enabled(cfg) else 1
        self.rank = pdist.rank() if self.world > 1 else 0
        # The gradient-combine policy, as the JAX package's (trainers/base.py:233-264):
        # "auto" is the DDP layout on more than one rank unless the tables are
        # sharded; an explicit True / "bf16" beside shard_tables raises.
        requested = rt.get("grad_psum", "auto")
        if requested and requested != "auto" and rt.get("shard_tables"):
            raise ValueError(
                "runtime.grad_psum and runtime.shard_tables are mutually exclusive: the DDP layout "
                "replicates the tables and their optimizer state, which shard_tables row-shards over the "
                "ranks. Enable at most one (grad_psum averages every gradient; shard_tables cuts "
                "optimizer-state memory).")
        self.grad_psum = (self.world > 1 and not rt.get("shard_tables")) if requested == "auto" else requested
        self._unsharded_warned = False
        self._gather_rays = False
        self.last_scalars = None  # the last logging step's scalars (every rank)

        # Model: initialized on the CPU from the seed (and re-drawn by
        # trainer.init), then moved, so the same seed gives the same weights
        # on every device and every rank.
        model_cls = resolve("model", cfg.model.type)
        self.model = model_cls(cfg.model, cfg.data, generator=torch.Generator().manual_seed(seed),
                               compute_dtype=self.compute_dtype)
        init_cfg = tcfg.get("init") or {}
        if (init_cfg.get("type") or "none") != "none":
            reinit_dense_weights(self.model, init_cfg["type"], float(init_cfg.get("gain") or 1.0),
                                 torch.Generator().manual_seed(seed + 9999))
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
        self.trainable_params = [p for _, p in trainable]
        # Indices into the optimizer's list.
        self.table_param_idx = [i for i, n in enumerate(self.trainable_names) if ".hash_table." in n]
        self.dp = None
        if pdist.is_initialized() and pdist.mesh_enabled(cfg) and (self.world > 1 or self.grad_psum
                                                                   or rt.get("shard_tables")):
            self.dp = pdist.DataParallel(self.trainable_params, self.trainable_names, self.grad_psum,
                                         bool(rt.get("shard_tables")))
        # The optimizer updates a sharded table's own rows (a view of them).
        shards = self.dp.shards if self.dp is not None else {}
        targets = [p.detach()[shards[i]] if i in shards else p for i, p in enumerate(self.trainable_params)]
        self.grad_accum = max(int(tcfg.get("grad_accum_iter", 1) or 1), 1)
        self.optimizer, self.lr_fn = optim_lib.make_optimizer(cfg.optim, targets, names=self.trainable_names,
                                                              max_iter=cfg.max_iter, grad_accum=self.grad_accum)

        # Image and ray picks draw from this generator, alike on every rank;
        # the stratified jitter from the same one on one process, from a
        # stream of each rank's own across ranks (JAX's fold_in(axis_index)).
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.render_generator = self.generator if self.world == 1 else \
            torch.Generator(device=self.device).manual_seed(seed + 7919 * (self.rank + 1))
        self.current_iteration = 0
        self.current_epoch = 0
        self._ckpt_prev_epoch = 0
        # CUDA graphs of the training step and the render chunk, and the
        # training window's device buffers: the schedule table [rows, K],
        # the step index into it, and the sums of each step's logged values.
        # Across ranks the step is captured where its collectives can be
        # (NCCL on a card); gloo ranks run it eagerly.
        nccl = pdist.captures_collectives(self.device)
        self.graph_steps = self.dp is None or nccl
        self.graphs = windows.StepGraphs(self.device, [self.generator, self.render_generator],
                                         capture_error_mode="thread_local" if nccl else "global")
        self._sched = self._sched_pos = self._sched_columns = None
        self._acc = self._acc_names = None
        self._render_buffers = {}
        self._trained_in_process = False
        is_main = pdist.is_main_process()
        self.checkpointer = Checkpointer(cfg, self.logdir, enabled=is_main)
        self.logger = MetricsLogger(self.logdir, use_wandb=bool(cfg.get("wandb")), wandb_name=cfg.get("wandb_name"),
                                    use_tensorboard=bool(cfg.get("tensorboard")), enabled=is_main)
        self.watchdog = Watchdog(cfg.get("timeout_period", 9999999))
        self.timer = PhaseTimer()
        self.weights = {k: float(v) for k, v in tcfg.get("loss_weight", {}).items() if v is not None}
        self.warm_start_report = self._maybe_warm_start(cfg)
        # EMA: a second copy of the model whose parameters are the average,
        # updated after every optimizer step; evaluation renders from it. It
        # is taken after the warm start, so it starts from the warm-started
        # weights (the JAX package copies the random init, then warm-starts
        # the params alone). A sharded table's average is updated on the
        # rank's own rows and gathered where it is read.
        self.ema_beta = float(tcfg.ema_config.beta) if tcfg.ema_config.enabled else None
        self.ema_model = None
        if self.ema_beta is not None:
            self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
            rows = {self.trainable_names[i]: r for i, r in shards.items()}
            ema = dict(self.ema_model.named_parameters())
            self._ema_pairs = tuple(zip(*[(ema[n].detach()[rows[n]], p.detach()[rows[n]]) if n in rows
                                          else (ema[n], p) for n, p in named]))
            self._ema_sharded = {i: ema[self.trainable_names[i]] for i in shards}
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
        """One eager step on ``batch`` (the global batch; across ranks each
        keeps its slice of the rays): a window of one step, its schedule
        read from the table that :meth:`run_window`'s steps read. Returns
        device tensors: total, losses, metrics and the gradient norms (across
        ranks, their parts, and the combine's timing spans)."""
        ((_, host, opt_key),) = self._start_window(1)
        info = self._window_step(None, host, opt_key, batch=batch)
        self._end_window(1, info)
        return info

    def _step(self, batch, cond, weights, opt_values, opt_key) -> Dict[str, Any]:
        """Render, loss, backward, the ranks' combine, the optimizer's update
        and the EMA, with the schedule's values as given (floats, or 0-dim
        tensors of a window's schedule row). Touches no host state, so that a
        CUDA graph can capture it."""
        if self.occupancy_grid is not None:
            cond["occupancy_grid"] = self.occupancy_grid
        sharded = False
        if self.world > 1:
            batch, sharded = pdist.shard_rays(batch, self.world, self.rank)
            if not sharded and not self._unsharded_warned:
                self._unsharded_warned = True
                shapes = {k: tuple(v.shape) for k, v in batch.items() if k == "ray_idx" or k.endswith("_sampled")}
                print(f"[grad_psum] WARNING: ray axes do not divide the {self.world}-rank world — every rank "
                      f"runs the whole batch (no ray sharding). Offending ray-axis shapes: {shapes}", flush=True)
        # The global layout's coupled losses read the whole global batch.
        self._gather_rays = sharded and self.dp is not None and self.dp.global_layout
        output = self.model(batch, cond, generator=self.render_generator, train=True)
        loss_dict, metric_dict = self.compute_loss(output, batch, mode="train")
        self._gather_rays = False
        total = torch.zeros((), device=self.device)
        for key, value in loss_dict.items():
            if key in weights:
                total = total + weights[key] * value
        grads = torch.autograd.grad(total, self.trainable_params, allow_unused=True)
        # A level the encoder skipped has no gradient; optax sees zeros there.
        # With partial training only the trainable parameters are here, and
        # the norms are over their gradients.
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.trainable_params, grads)]
        info = dict(total=total.detach(), losses={k: v.detach() for k, v in loss_dict.items()},
                    metrics={k: v.detach() for k, v in metric_dict.items()})
        if self.dp is None:
            info["grad_norm"] = optim_lib.global_norm(grads, self.device)
            info["table_grad_norm"] = optim_lib.global_norm([grads[i] for i in self.table_param_idx], self.device)
        else:
            grads = self.dp.combine(grads)
            info["grad_sq"] = self.dp.sq_norms(grads, self.table_param_idx)
        self.optimizer.update(grads, opt_values, opt_key)
        if self.dp is not None:
            if self.dp.shards:
                self.dp.gather_rows({i: self.trainable_params[i] for i in self.dp.shards})
            info["combine_spans"] = self.dp.spans
        if self.ema_model is not None:
            optim_lib.ema_update(*self._ema_pairs, self.ema_beta)
        return info

    def global_rays(self, *tensors: torch.Tensor):
        """Per-ray tensors of this step as the global batch: gathered from
        every rank in the global layout (a loss that is not a plain mean over
        the rays, such as a ratio of means or a range over the batch, then
        takes the value of the whole batch); as they are otherwise."""
        return pdist.gather_rays(*tensors) if self._gather_rays else tensors

    # ------------------------------------------------------------------
    # Dispatch windows
    # ------------------------------------------------------------------

    # Cond entries that change every step: a window's steps read them from
    # the schedule table (the rest of the cond keys the step's graph).
    DEVICE_COND = ("progress", "cos_anneal")

    def step_schedule(self, iteration: int, j: int, max_levels) -> Tuple[Dict[str, float], Dict[str, Any], Any]:
        """The ``j``-th step of a window, at ``iteration``: (its schedule
        values by column name: the cond's per-step values, the loss weights
        ``w.<loss>`` and the optimizer's ``opt.<name>``, all float32-exact;
        the host part of its cond, with the window's level cap; the
        optimizer's branch key)."""
        cond = self.make_cond(iteration)
        cond["max_levels"] = max_levels
        weights = self.loss_weights_at(iteration, cond)
        host, values = windows.split_cond(cond, self.DEVICE_COND)
        values.update({f"w.{k}": float(v) for k, v in weights.items()})
        opt_values, opt_key = self.optimizer.plan(j)
        values.update({f"opt.{k}": v for k, v in opt_values.items()})
        return values, host, opt_key

    def _window_buffers(self, columns, n: int):
        """The schedule table (at least ``n`` rows of ``columns``) and its step
        index; reallocating them drops the graphs that read them."""
        if self._sched is None or self._sched_columns != columns or self._sched.shape[0] < n:
            rows = max(n, 0 if self._sched is None else self._sched.shape[0])
            self._sched = torch.zeros(rows, len(columns), dtype=torch.float32, device=self.device)
            self._sched_pos = torch.zeros((), dtype=torch.int64, device=self.device)
            self._sched_columns = list(columns)
            self.graphs.clear()

    def run_window(self, arrays: Dict[str, torch.Tensor], n: int) -> int:
        """Run ``n`` training steps from the current iteration as one window:
        the schedule of its steps in one table copied to the device, the
        level cap of its last step for all of them (exact: the level mask
        zeroes what the cap lets through), each step a CUDA-graph replay on
        a card, across NCCL ranks with the combine inside (eager on gloo
        ranks). The steps add their logged values into the window's sums on
        the device; :meth:`window_means` reads them. Returns ``n``."""
        info = None
        for _, host, opt_key in self._start_window(n):
            fn = functools.partial(self._window_step, arrays, host, opt_key)
            if self.graph_steps:
                info = self.graphs.run(("train",) + windows.window_key(host, opt_key), fn)
            else:
                info = fn()
        self._end_window(n, info)
        return n

    def _start_window(self, n: int):
        """The schedule of the next ``n`` steps in the device table, its step
        index and the window's sums at 0. Returns each step's (values, host
        cond, optimizer branch key)."""
        it0 = self.current_iteration
        max_levels = self.static_max_levels_for(it0 + n - 1)
        plans = [self.step_schedule(it0 + j, j, max_levels) for j in range(n)]
        columns = list(plans[0][0])
        self._window_buffers(columns, n)
        table = torch.from_numpy(np.asarray([[v[c] for c in columns] for v, _, _ in plans], np.float32))
        if self.device.type == "cuda":
            table = table.pin_memory()
        self._sched[:n].copy_(table, non_blocking=True)
        self._sched_pos.zero_()
        if self._acc is not None:
            self._acc.zero_()
        return plans

    def _end_window(self, n: int, last_info):
        """Advance the iteration and the optimizer's count by ``n``; across
        ranks, keep the last step's combine spans as the window's."""
        self.optimizer.advance(n)
        self.current_iteration += n
        if self.dp is not None:
            self.dp.end_window(last_info["combine_spans"])

    def _window_step(self, arrays, host_cond, opt_key, batch=None):
        """One step of a window: its schedule row through the device step
        index, the step on ``batch`` (or one drawn from ``arrays``), its
        logged values added into the window's sums. Returns the step's info."""
        row = self._sched.index_select(0, self._sched_pos.view(1))[0]
        vals = windows.device_values(self._sched_columns, row)
        cond = windows.join_cond(host_cond, vals, self.DEVICE_COND)
        weights = {k[2:]: v for k, v in vals.items() if k.startswith("w.")}
        opt_values = {k[4:]: v for k, v in vals.items() if k.startswith("opt.")}
        info = self._step(self.sample_batch(arrays) if batch is None else batch, cond, weights, opt_values, opt_key)
        values = torch.stack([info["total"], *info["losses"].values(), *info["metrics"].values()]).float()
        if self.dp is None:
            norms = torch.stack([info["grad_norm"], info["table_grad_norm"]]).float()
        else:  # the ranks' means and the combined gradient's norms
            values, norms = self.dp.reduce_info(values, info["grad_sq"])
        logged = torch.cat([values, norms])
        if self._acc is None:
            self._acc_names = (["total"] + [f"loss/{k}" for k in info["losses"]]
                               + [f"metric/{k}" for k in info["metrics"]] + ["grad_norm", "table_grad_norm"])
            self._acc = torch.zeros_like(logged)
        self._acc.add_(logged)
        self._sched_pos.add_(1)
        return info

    def window_means(self, n: int) -> Dict[str, Any]:
        """The last window's means (one host read): total, losses, metrics,
        grad_norm, table_grad_norm."""
        means = dict(zip(self._acc_names, (self._acc / n).tolist()))
        return dict(total=means["total"], grad_norm=means["grad_norm"], table_grad_norm=means["table_grad_norm"],
                    losses={k[5:]: v for k, v in means.items() if k.startswith("loss/")},
                    metrics={k[7:]: v for k, v in means.items() if k.startswith("metric/")})

    # ------------------------------------------------------------------
    # Train loop
    # ------------------------------------------------------------------

    def train(self, train_arrays: Dict[str, np.ndarray], val_dataset=None, show_progress: bool = False):
        """Train from the current iteration to ``max_iter`` in dispatch
        windows: each ends on every logging, validation and checkpoint step
        (the gcd of their cadences) and holds at most
        ``trainer.steps_per_dispatch`` steps (``windows.steps_per_dispatch``).
        Refreshes the occupancy grid at window starts when it is due; at each
        logging step logs the last window's means and aborts on a
        non-finite total there; validates on ``val_dataset`` every
        ``validation_iter`` steps and saves checkpoints as ``cfg.checkpoint``
        says. Across ranks it first checks that every rank holds the same
        parameters. Returns the last logged means."""
        cfg = self.cfg
        # Renders later in this process take the post-training render window.
        self._trained_in_process = True
        arrays = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in train_arrays.items()}
        if self._needs_light() and "pose_light" not in arrays:
            raise KeyError("this trainer needs per-image light poses ('pose_light')")
        if self.dp is not None:
            self.dp.check_replicas([p.detach() for p in self.model.parameters()], "parameters at the start of training")
        max_iter, start_iter = cfg.max_iter, self.current_iteration
        log_iter = min(cfg.logging_iter, cfg.get("wandb_scalar_iter", cfg.logging_iter))
        val_iter = cfg.get("validation_iter", 10**12)
        images_per_epoch = max(arrays["pose"].shape[0], 1)
        rays_per_step = self.num_rand_rays() * cfg.data.train.batch_size
        cadence = windows.cadence(cfg, start_iter)
        spd, auto = windows.steps_per_dispatch(cfg, cadence, self.device, self.num_params)
        self.graphs.clear()  # the graphs read the dataset's tensors
        if self.dp is not None:
            backend = pdist.dist.get_backend()
            if not self.graph_steps:
                how = (f"eager steps ({backend} runs its collectives on the host, which a CUDA graph cannot "
                       "capture)")
            elif self.graphs.enabled:
                how = "CUDA-graph replays, the NCCL combine inside each step's graph"
            else:
                how = "eager steps (graphs off)"
            print(f"[window] {self.world} ranks ({backend}, {self.device.type}): windows of up to {spd} steps "
                  f"run as {how}", flush=True)
        info = None
        t_window, iters_in_window = time.perf_counter(), 0
        self.watchdog.reset()
        it = start_iter
        while it < max_iter:
            self.maybe_update_occupancy()
            n = min(spd, max_iter - it, cadence - it % cadence)  # never across a cadence boundary
            self.timer.start_iteration()
            if auto and it > start_iter and self._window_ready(n):
                # Lock the window from one timed window of replayed steps.
                _sync(self.device)
                t0 = time.perf_counter()
                self.run_window(arrays, n)
                self.window_means(n)
                t_step = (time.perf_counter() - t0) / n
                if self.dp is not None:  # one window size on every rank: the graphs' buffers follow it
                    t_step = self.dp.agree(t_step)
                spd, auto = windows.auto_window(cfg, t_step, cadence), False
                print(f"[trainer] auto steps_per_dispatch: {t_step:.4f} s/step -> window {spd} "
                      f"(budget {float(cfg.trainer.get('dispatch_time_budget', 45.0)):.0f} s)", flush=True)
            else:
                self.run_window(arrays, n)
            self.timer.end_iteration()
            it = self.current_iteration
            iters_in_window += n
            self.current_epoch = it * cfg.data.train.batch_size // images_per_epoch
            logged = it % log_iter == 0 or it == max_iter
            if logged:
                info = self.window_means(n)  # waits for the device
                self._log_step(info, it, rays_per_step, t_window, iters_in_window, show_progress)
                t_window, iters_in_window = time.perf_counter(), 0
                self.watchdog.reset()
            if val_dataset is not None and it % val_iter == 0:
                self.validate(val_dataset, step=it)
            self._checkpoint_triggers(it, logged)
        self.watchdog.disarm()
        return info

    def _window_ready(self, n: int) -> bool:
        """Whether every step of the next ``n``-step window would replay (for
        eager steps: always)."""
        if not self.graph_steps:
            return True
        it0 = self.current_iteration
        max_levels = self.static_max_levels_for(it0 + n - 1)
        keys = []
        for j in range(n):
            _, host, opt_key = self.step_schedule(it0 + j, j, max_levels)
            keys.append(("train",) + windows.window_key(host, opt_key))
        return self.graphs.ready(keys)

    @torch.no_grad()
    def maybe_update_occupancy(self):
        """Refresh the occupancy grid from the SDF at the grid's cell
        centres (one field evaluation at the current iteration's schedule,
        every hash level) when it is due: at the first window and at the
        first window start ``update_every`` steps or more after the last
        refresh. The grid is rewritten in place, where the step's graphs
        read it."""
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
        grid = occ_ops.occupancy_from_sdf(sdf, res, rmin, rmax, float(occ.get("band_cells", 3.0)))
        if self.occupancy_grid is None or self.occupancy_grid.shape != grid.shape:
            self.occupancy_grid = grid
            self.graphs.clear()
        else:
            self.occupancy_grid.copy_(grid)
        self._occupancy_iter = it

    def _log_step(self, info, it: int, rays_per_step: int, t_window: float, iters_in_window: int,
                  show_progress: bool):
        """Log ``info`` (:meth:`window_means`) at step ``it``."""
        total = info["total"]
        if not np.isfinite(total):
            raise FloatingPointError(f"Training loss is {total} at iteration {it} — aborting "
                                     "(NaN/Inf kill-switch).")
        dt = (time.perf_counter() - t_window) / iters_in_window
        scalars = {
            "train/total_loss": total,
            "train/iter_time": dt,
            "train/rays_per_sec": rays_per_step / dt,
            "optim/lr": float(self.lr_fn(it)),
            "train/grad_norm": info["grad_norm"],
            "train/table_grad_norm": info["table_grad_norm"],
            **{f"train/loss/{k}": v for k, v in info["losses"].items()},
            **{f"train/{k}": v for k, v in info["metrics"].items()},
        }
        if self.dp is not None:
            combine_ms = self.dp.combine_ms()
            scalars["dist/combine_ms"] = float(np.mean(combine_ms)) if combine_ms else 0.0
            scalars["dist/combine_bytes"] = self.dp.step_bytes
        self.last_scalars = scalars
        self.logger.log_scalars(scalars, it)
        if show_progress and pdist.is_main_process():
            msg = ", ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in scalars.items()
                            if "loss" in k or "psnr" in k)
            print(f"[iter {it}/{self.cfg.max_iter}] {msg} ({dt * 1000:.1f} ms/it)", flush=True)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_triggers(self, iteration: int, logged: bool = True):
        ck = self.cfg.checkpoint
        save = iteration % ck.save_iter == 0
        save_epoch = ck.get("save_epoch")
        if save_epoch:
            # Crossing a multiple of save_epoch, however far the epoch moved.
            if self.current_epoch // save_epoch > self._ckpt_prev_epoch // save_epoch:
                save = True
            self._ckpt_prev_epoch = self.current_epoch
        if self.dp is not None and self.dp.shards:
            # A save gathers the sharded state on every rank: rank 0's clock
            # decides, at the logging steps (which wait for the device anyway).
            period = logged and self.dp.agree(self.checkpointer.reached_checkpointing_period())
        else:
            period = self.checkpointer.reached_checkpointing_period()
        latest = iteration % ck.save_latest_iter == 0 or period
        if save or latest:
            self.save_checkpoint(iteration, latest=latest)

    def _sharded_state(self, state, fn):
        """``state`` (an optimizer state dict) with ``fn(i, leaf)`` applied to
        each sharded leaf of its per-parameter lists."""
        n = len(self.trainable_params)
        if isinstance(state, dict):
            return {k: self._sharded_state(v, fn) for k, v in state.items()}
        if isinstance(state, list) and len(state) == n and all(isinstance(t, torch.Tensor) for t in state):
            return [fn(i, t) if i in self.dp.shards else t for i, t in enumerate(state)]
        return state

    def _sync_ema(self):
        """Gather the sharded tables' averages (a collective: every rank)."""
        if self.ema_model is not None and self._ema_sharded:
            self.dp.gather_rows(self._ema_sharded, timed=False)

    def save_checkpoint(self, iteration: Optional[int] = None, latest: bool = False):
        """Save the state (rank 0 writes; every rank calls this, as a
        sharded table's moments and average are gathered first)."""
        iteration = self.current_iteration if iteration is None else int(iteration)
        sharded = self.dp is not None and bool(self.dp.shards)
        if not sharded and not self.checkpointer.enabled:
            return
        opt_state = self.optimizer.state_dict()
        if sharded:
            opt_state = self._sharded_state(opt_state, self.dp.gather_leaf)
            self._sync_ema()
        if not self.checkpointer.enabled:
            return
        state = dict(params=_host_state(self.model), opt_state=opt_state,
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
        trained iteration. A JAX package checkpoint's optax state goes
        through the bridge; under ``runtime.shard_tables`` each rank keeps
        its rows of the tables' moments. Returns whether a checkpoint was
        found."""
        payload, path = self.checkpointer.load(checkpoint_path)
        if payload is None:
            print("[checkpoint] training from scratch")
            return False
        st = payload["state"]
        self.graphs.clear()
        self.model.load_state_dict(st["params"])
        if self.ema_model is not None:
            self.ema_model.load_state_dict(st.get("ema_params") or st["params"])
        if st.get("iteration") is not None and (self.is_inference or resume):
            self.current_iteration = int(st["iteration"])
        opt_state = st.get("opt_state")
        if opt_state is None and st.get("jax_opt_state") is not None:
            opt_state = opt_state_from_jax(st["jax_opt_state"], self.trainable_names)
        if resume and load_opt and opt_state is not None:
            if self.dp is not None and self.dp.shards:
                opt_state = self._sharded_state(opt_state, lambda i, t: t[self.dp.shards[i]])
            self.optimizer.load_state_dict(opt_state)
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
        ``render_chunk``.

        The rays go in chunks of ``num_rays_chunk`` (the last padded with
        copies of the image's last ray, its outputs trimmed), in windows of
        chunks with one copy to the host each: every chunk in one window with
        ``runtime.fused_inference`` (the default on the CPU), else
        ``windows.inference_window`` chunks. On a CUDA device each chunk is
        a replay of a CUDA graph of ``render_chunk``, keyed by the render
        kwargs, the cond's host part (the level cap and mask) and the chunk's
        shape. Every chunk has one shape, so the outputs do not depend on
        the window."""
        H, W = image_size
        total = H * W
        R = min(int(num_rays_chunk or self.num_val_rays()), total)
        it = self.current_iteration
        cond = self.make_cond(it)
        cond["max_levels"] = self.static_max_levels_for(it)
        host_cond, values = windows.split_cond(cond, self.DEVICE_COND)
        pose = torch.as_tensor(np.asarray(data["pose"]), device=self.device)
        intr = torch.as_tensor(np.asarray(data["intr"]), device=self.device)
        center, ray = camera.get_center_and_ray(pose, intr, (H, W))
        rays = {"center": center, "ray": ray}
        if "pose_light" in data and self._needs_light():
            pose_light = torch.as_tensor(np.asarray(data["pose_light"]), device=self.device)
            rays["pts_light"] = camera.get_camera_center(pose_light, num_pixels=1).expand_as(ray)
        chunks = -(-total // R)
        pad = chunks * R - total
        if pad:
            rays = {k: torch.cat([v, v[:, -1:].expand(-1, pad, -1)], dim=1) for k, v in rays.items()}
        B = center.shape[0]
        model = self.eval_model()
        kwargs = dict(render_kwargs or {})
        key = ("render", id(model), tuple(sorted(kwargs.items())), B, R, tuple(rays),
               windows.window_key(host_cond, None))
        columns = list(values)
        buf = self._render_buffers.get(key)
        if buf is None:
            buf = self._render_buffers[key] = dict(
                values=torch.zeros(len(columns), dtype=torch.float32, device=self.device),
                **{k: torch.zeros(B, R, 3, dtype=v.dtype, device=self.device) for k, v in rays.items()})
        buf["values"].copy_(torch.tensor([values[c] for c in columns], dtype=torch.float32))

        @torch.no_grad()
        def render_one():
            chunk_cond = windows.join_cond(host_cond, windows.device_values(columns, buf["values"]),
                                           self.DEVICE_COND)
            extra = dict(kwargs, **({"pts_light": buf["pts_light"]} if "pts_light" in buf else {}))
            out = model.render_chunk(buf["center"], buf["ray"], chunk_cond, **extra)
            # Per-ray outputs only: the per-sample ones would hold the
            # whole image's samples.
            return {k: v for k, v in out.items() if isinstance(v, torch.Tensor) and v.ndim == 3 and v.shape[1] == R}

        per_window = chunks if windows.fused_inference(self.cfg, self.device) else \
            windows.inference_window(self.cfg, R, self._trained_in_process)
        pieces = []
        for w0 in range(0, chunks, per_window):
            outs = []
            for c in range(w0, min(w0 + per_window, chunks)):
                for k, v in rays.items():
                    buf[k].copy_(v[:, c * R:(c + 1) * R])
                # A replay rewrites the graph's outputs: keep a copy.
                outs.append({k: v.clone() for k, v in self.graphs.run(key, render_one).items()})
            host = {k: torch.cat([o[k] for o in outs], dim=1).cpu().numpy() for k in outs[0]}
            pieces.append(host)
        out = {k: np.concatenate([p[k] for p in pieces], axis=1) for k in pieces[0]}
        return {k: v[:, :total] for k, v in out.items()}

    def inference_outputs(self, data, image_size) -> Dict[str, np.ndarray]:
        """Full inference pass: ``*_map`` images [B,H,W,C]."""
        return outputs_to_maps(self.render_image(data, image_size), data, image_size)

    def validate(self, val_dataset, step: int, max_samples: int = 4) -> Optional[float]:
        """Render up to ``max_samples`` validation images and log their mean
        PSNR (``val/psnr``), with ``val/psnr_ref`` and ``val/psnr_sha``
        where the dataset carries ground-truth intrinsics and the model
        renders them, and the first image's render, target and normal map
        (``log_images``). Across ranks rank 0 renders and the others wait
        (they return None)."""
        self._sync_ema()
        if not pdist.is_main_process():
            pdist.sync_processes("validation")
            return None
        image_size = self.cfg.data.val.image_size
        psnrs = []
        comp_psnrs: Dict[str, list] = {}
        logged_images = {}

        def _psnr(a, b):
            return -10 * np.log10(np.mean((a - b) ** 2) + 1e-12)

        for i in range(min(len(val_dataset), max_samples)):
            sample = val_dataset[i]
            data = {k: np.asarray(v)[None] for k, v in sample.items() if not np.isscalar(v)}
            maps = self.inference_outputs(data, image_size)
            pred, gt = maps["rgb_map"][0], np.asarray(sample["image"])
            psnrs.append(_psnr(pred, gt))
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
            if i == 0:
                logged_images["val/rgb_render"] = pred
                logged_images["val/rgb_target"] = gt
                if "normal_map" in maps:
                    logged_images["val/normal"] = maps["normal_map"][0] * 0.5 + 0.5
        scalars = {"val/psnr": float(np.mean(psnrs))}
        scalars.update({f"val/{k}": float(np.mean(v)) for k, v in comp_psnrs.items()})
        self.logger.log_scalars(scalars, step)
        self.logger.log_images(logged_images, step)
        comp_msg = "".join(f", {k.split('_')[1]} {np.mean(v):.2f}" for k, v in sorted(comp_psnrs.items()))
        print(f"[val @ {step}] PSNR = {np.mean(psnrs):.2f} dB{comp_msg}", flush=True)
        pdist.sync_processes("validation")
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


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
