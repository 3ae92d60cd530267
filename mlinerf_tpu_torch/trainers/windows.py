"""Dispatch windows: the JAX package's scanned training windows and windowed
renders (``mlinerf_tpu/trainers/base.py`` ``train``, ``_inference_window``,
``_use_fused_inference``), with their sizing rules as there.

A training window is ``n`` steps between two host reads: the trainer reads
the window's mean losses, metrics and gradient norms once at its end, so the
host only enqueues work inside it. A render window is a group of fixed-size
ray chunks whose outputs come back to the host in one copy.

On a CUDA device each fixed-shape program runs as a CUDA graph
(:class:`StepGraphs`): a training step or a chunk's render is captured once
and replayed, so a step costs one graph launch on the host instead of
thousands of kernel launches. What a replay must not bake in (the learning
rate, the bias corrections, the loss weights, the NeuS anneal) it reads from
a device tensor that the host fills once per window; what changes a step's
shapes or its host control flow (the coarse-to-fine level cap and mask, the
normal epsilon, an optimizer's branch) keys the graph.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

from mlinerf_tpu_torch.ops import hashgrid, hashgrid_scatter

# The cap on a sized window, as the JAX package's device default and "auto".
MAX_WINDOW = 32

# The kernel-launch counters that a replay credits with the launches its
# capture recorded: (module, attribute), each an int or a dict of ints.
COUNTERS = ((hashgrid_scatter, "launches"), (hashgrid_scatter, "launches_by_width"), (hashgrid, "gathers"))


def cadence(cfg, start_iter: int) -> int:
    """The gcd of every active cadence (logging, scalars, validation, both
    checkpoint intervals), so that a window ends on each of their steps;
    with none active, the rest of the run."""
    log_iter = cfg.logging_iter
    active = [c for c in (log_iter, cfg.get("wandb_scalar_iter", log_iter), cfg.get("validation_iter", 10**12),
                          cfg.checkpoint.save_iter, cfg.checkpoint.save_latest_iter)
              if c and c <= cfg.max_iter]
    return math.gcd(*active) if active else max(cfg.max_iter - start_iter, 1)


def steps_per_dispatch(cfg, window_cadence: int, device: torch.device, num_params: int) -> Tuple[int, bool]:
    """(window, auto): ``trainer.steps_per_dispatch`` as an int, or for None
    the JAX package's defaults: on the CPU min(cadence, 100); on a device 32
    with the shared-level stencil, 32 under 4M parameters, else 5, each at
    most the cadence. ``"auto"`` starts at 1 and is sized later by
    :func:`auto_window`."""
    spd = cfg.trainer.get("steps_per_dispatch")
    if isinstance(spd, str) and spd == "auto":
        return 1, True
    if spd is None:
        if device.type == "cpu":
            spd = min(window_cadence, 100)
        else:
            grad_cfg = cfg.model.get("object", {}).get("sdf", {}).get("gradient", {}) if "object" in cfg.model else {}
            if grad_cfg.get("shared_levels") or num_params < 4e6:
                spd = min(window_cadence, MAX_WINDOW)
            else:
                spd = min(window_cadence, 5)
    return max(int(spd), 1), False


def auto_window(cfg, step_seconds: float, window_cadence: int) -> int:
    """The window that fits ``trainer.dispatch_time_budget`` seconds (45) of
    measured step time, capped at 32 and at the cadence. The JAX package
    subtracts a measured per-dispatch intercept of its remote TPU transport
    first; a CUDA graph's launch is microseconds, so the step time here is
    one replayed step's wall time after a synchronize, with nothing taken
    off."""
    budget = float(cfg.trainer.get("dispatch_time_budget", 45.0))
    return max(min(int(budget // max(step_seconds, 1e-6)), MAX_WINDOW, window_cadence), 1)


def inference_window(cfg, num_rays_chunk: int, trained_in_process: bool) -> int:
    """Chunks per render window (``_inference_window``): an int in
    ``runtime.inference_chunks_per_dispatch`` forces it; for ``auto`` (or
    None) 1 above 4,096 rays per chunk, 4 once train() has run in this
    process, 4 for heavy configs (dict 2^20 or more, or more than 96
    samples per ray), else 32."""
    forced = (cfg.get("runtime") or {}).get("inference_chunks_per_dispatch")
    if forced not in (None, "auto"):
        return int(forced)
    if num_rays_chunk > 4096:
        return 1
    if trained_in_process:
        return 4
    mcfg = cfg.model
    dict_size = mcfg.get("object", {}).get("sdf", {}).get("encoding", {}).get("hashgrid", {}).get("dict_size", 0)
    rcfg = mcfg.get("render", {})
    ns = rcfg.get("num_samples", {})
    samples = ns.get("coarse", 0) + rcfg.get("num_sample_hierarchy", 0) * ns.get("fine", 0)
    return 4 if dict_size >= 20 or samples > 96 else 32


def fused_inference(cfg, device: torch.device) -> bool:
    """Whether a render is one window of every chunk
    (``runtime.fused_inference``; by default on the CPU only)."""
    forced = (cfg.get("runtime") or {}).get("fused_inference")
    return bool(forced) if forced is not None else device.type == "cpu"


def hashable(value) -> Hashable:
    """A cond entry as a graph-key part: arrays and sequences as tuples."""
    if isinstance(value, np.ndarray):
        return tuple(value.tolist())
    if isinstance(value, (list, tuple)):
        return tuple(hashable(v) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    return value


def _counts():
    return [_copy(getattr(module, name)) for module, name in COUNTERS]


def _copy(count):
    return dict(count) if isinstance(count, dict) else count


def _diff(after, before):
    if isinstance(after, dict):
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return after - before


def _add_counts(delta, sign: int = 1):
    """Add ``sign`` times ``delta`` to the counters (a dict in place)."""
    for (module, name), d in zip(COUNTERS, delta):
        count = getattr(module, name)
        if isinstance(count, dict):
            for k, v in d.items():
                count[k] = count.get(k, 0) + sign * v
        else:
            setattr(module, name, count + sign * d)


class StepGraphs:
    """CUDA graphs of fixed-shape programs, keyed, in one memory pool.

    ``run(key, fn)`` on a CUDA device: the first time a key comes, ``fn``
    runs eagerly on a side stream (its warm-up: lazy builds, caches and
    library handles happen outside any capture); the second time it is
    captured (with every device generator registered, so a replay draws what
    an eager run would) and replayed; after that, replayed. On the CPU ``fn``
    just runs. A capture runs under ``torch.cuda.set_sync_debug_mode
    ("error")``, so an operation that waits for the device inside the
    program raises there, and a capture or replay failure raises: nothing
    falls back to eager steps.

    The graphs share one pool and keep their outputs alive, and they replay
    one after another on one stream, so no graph's memory is another's live
    tensor. A graph holds the addresses of everything it reads: :meth:`clear`
    drops them when those tensors are replaced (a new dataset, a checkpoint
    load, resized window buffers).

    The launch counters (:data:`COUNTERS`) count at each launch: a capture
    records its launches without counting them, and each replay credits the
    counters with what its capture recorded.

    ``capture_error_mode`` is ``torch.cuda.graph``'s: ``"thread_local"`` in a
    process with an NCCL group, whose watchdog thread queries the events of
    earlier collectives while a step is captured (``"global"`` holds every
    thread of the process to the capture's rules); the capturing thread is
    held to them in both.
    """

    def __init__(self, device: torch.device, generators: Sequence[torch.Generator] = (),
                 capture_error_mode: str = "global"):
        self.device = torch.device(device)
        self.capture_error_mode = capture_error_mode
        # False runs every key eagerly on a card too: the eager step that a
        # measurement sets beside the captured one.
        self.enabled = self.device.type == "cuda"
        self.generators = list({id(g): g for g in generators}.values())
        self.graphs: Dict[Hashable, Tuple[Any, Any, list]] = {}
        self.warm = set()
        self.pool = None
        self.captures = 0
        self.replays = 0
        self.eager_runs = 0

    def clear(self):
        self.graphs.clear()
        self.warm.clear()

    def ready(self, keys) -> bool:
        """Whether every key would replay a graph (on the CPU: has run)."""
        return all((k in self.graphs) if self.enabled else (k in self.warm) for k in keys)

    def run(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        if not self.enabled:
            self.warm.add(key)
            return fn()
        entry = self.graphs.get(key)
        if entry is None and key not in self.warm:
            self.warm.add(key)
            self.eager_runs += 1
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out = fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            return out
        if entry is None:
            entry = self.graphs[key] = self._capture(fn)
        graph, out, delta = entry
        graph.replay()
        self.replays += 1
        _add_counts(delta)
        return out

    def _capture(self, fn):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _counts()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode=self.capture_error_mode):
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        delta = [_diff(a, b) for a, b in zip(_counts(), before)]
        _add_counts(delta, -1)
        self.captures += 1
        return graph, out, delta


def split_cond(cond: Dict[str, Any], device_keys: Sequence[str]) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """(host part, device values) of a cond: each entry named in
    ``device_keys`` becomes one value (a tuple one per element, named
    ``key.i``); the rest stays as it is."""
    host, values = {}, {}
    for k, v in cond.items():
        if k not in device_keys:
            host[k] = v
        elif isinstance(v, tuple):
            values.update({f"{k}.{i}": float(x) for i, x in enumerate(v)})
        else:
            values[k] = float(v)
    return host, values


def join_cond(host: Dict[str, Any], values: Dict[str, Any], device_keys: Sequence[str]) -> Dict[str, Any]:
    """The cond of :func:`split_cond`'s parts, the device values as given
    (floats or 0-dim tensors)."""
    cond = dict(host)
    for k in device_keys:
        if k in values:
            cond[k] = values[k]
        elif f"{k}.0" in values:
            n = sum(1 for name in values if name.startswith(f"{k}."))
            cond[k] = tuple(values[f"{k}.{i}"] for i in range(n))
    return cond


def window_key(host_cond: Dict[str, Any], opt_key) -> Tuple:
    """A training step's graph key: its host cond and optimizer branch."""
    return tuple(sorted((k, hashable(v)) for k, v in host_cond.items())), hashable(opt_key)


def device_values(columns: Sequence[str], row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Name -> 0-dim view of a schedule row."""
    return dict(zip(columns, row.unbind(0)))
