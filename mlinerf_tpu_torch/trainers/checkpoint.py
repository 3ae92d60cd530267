"""Checkpoints: the JAX package's file names, ``latest_checkpoint.txt``
pointer and save triggers, with the port's own payload.

The port writes ``{"state": {"params": state_dict, "opt_state": ...,
"ema_params": state_dict or None, "iteration": k}, "epoch": e,
"iteration": k}`` with ``torch.save`` (a bfloat16 table has no numpy dtype
without ``ml_dtypes``). ``load_file`` also reads a checkpoint written by the
JAX package, a pickle of numpy trees: its params and EMA params go through
the bridge, and its optimizer state is not loaded.
``nonstrict_restore`` carries the leaves of one model's state dict into
another's where name and shape agree (the stage-b warm start).
"""

from __future__ import annotations

import os
import pickle
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch

from mlinerf_tpu_torch.bridge import params_from_jax, params_from_jax_checkpoint

# Globals a JAX package checkpoint may name that the loader builds: numpy
# arrays (bfloat16 ones through ml_dtypes) and plain containers.
_NUMPY_GLOBALS = {"_reconstruct", "_frombuffer", "ndarray", "dtype", "scalar"}
_BUILTIN_GLOBALS = {"tuple", "list", "dict", "set", "frozenset", "int", "float", "complex", "bool", "slice"}


class _Skipped:
    """Stands in for every other class in a JAX package checkpoint (the
    optax optimizer state): built from nothing, it runs no code."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if (root == "numpy" and name in _NUMPY_GLOBALS) or root == "ml_dtypes" \
                or (module == "builtins" and name in _BUILTIN_GLOBALS):
            return super().find_class(module, name)
        return _Skipped


class Checkpointer:
    """Saves and loads training state and keeps the time-based save period
    (the trainer's ``_checkpoint_triggers`` decide the other saves)."""

    def __init__(self, cfg, logdir: str):
        self.logdir = logdir
        self.save_period = cfg.checkpoint.save_period  # minutes
        self._last_period_save = time.time()
        os.makedirs(logdir, exist_ok=True)

    @staticmethod
    def checkpoint_name(epoch: int, iteration: int) -> str:
        return f"epoch_{epoch:05d}_iteration_{iteration:09d}_checkpoint.pkl"

    def reached_checkpointing_period(self) -> bool:
        if time.time() - self._last_period_save > self.save_period * 60:
            self._last_period_save = time.time()
            return True
        return False

    def save(self, state: Dict[str, Any], epoch: int, iteration: int, latest: bool = False):
        """Write ``state`` (CPU tensors, ints, lists, dicts) and point
        ``latest_checkpoint.txt`` at it."""
        name = "latest_checkpoint.pkl" if latest else self.checkpoint_name(epoch, iteration)
        path = os.path.join(self.logdir, name)
        torch.save(dict(state=state, epoch=epoch, iteration=iteration), path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.logdir, "latest_checkpoint.txt"), "w") as f:
            f.write(name + "\n")

    def read_latest_checkpoint_file(self) -> Optional[str]:
        path = os.path.join(self.logdir, "latest_checkpoint.txt")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.readline().strip()
        return os.path.join(self.logdir, name) if name else None

    @staticmethod
    def load_file(path: str) -> Dict[str, Any]:
        """The payload at ``path`` (a checkpoint or a ``.txt`` pointer). A
        JAX package checkpoint comes back in the port's layout, with its
        params and EMA params bridged and ``opt_state`` None."""
        if path.endswith(".txt"):
            with open(path) as f:
                name = f.readline().strip()
            if not name:
                raise FileNotFoundError(f"Empty latest pointer {path}")
            path = os.path.join(os.path.dirname(path), name)
        if zipfile.is_zipfile(path):  # torch.save's format
            return torch.load(path, map_location="cpu", weights_only=True)
        with open(path, "rb") as f:
            payload = _JaxCheckpointUnpickler(f).load()
        state = payload["state"]
        ema = state.get("ema_params")
        return dict(state=dict(params=params_from_jax_checkpoint(payload), opt_state=None,
                               ema_params=params_from_jax(ema) if ema is not None else None,
                               iteration=state.get("iteration")),
                    epoch=payload.get("epoch"), iteration=payload.get("iteration"))

    def load(self, checkpoint_path: Optional[str] = None) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
        """Resolve (explicit path > latest pointer > none) and load.
        Returns (payload or None, the path loaded or None)."""
        path = checkpoint_path or self.read_latest_checkpoint_file()
        if path is None or not os.path.exists(path):
            return None, None
        return self.load_file(path), path


def nonstrict_restore(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor]):
    """Copy the leaves of ``source`` into ``target`` (two state dicts) where
    both the name and the shape agree: the stage-a -> stage-b warm start.

    Returns (the new state dict, report), the report listing ``missing``
    (in the target only), ``unexpected`` (in the source only) and
    ``mismatched`` (in both, with other shapes) names. A leaf keeps the
    target's dtype."""
    out = dict(target)
    unexpected, mismatched = [], []
    for name, value in source.items():
        if name not in target:
            unexpected.append(name)
        elif tuple(target[name].shape) != tuple(value.shape):
            mismatched.append(name)
        else:
            out[name] = value.to(target[name].dtype)
    missing = [name for name in target if name not in source]
    return out, dict(missing=missing, unexpected=unexpected, mismatched=mismatched)
