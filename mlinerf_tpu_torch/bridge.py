"""Carry parameters from the JAX package's param tree into the port.

``params_from_jax`` takes the tree of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives and returns a state dict for the
port's modules, whose attribute names follow the tree:

* a flax ``kernel`` [in, out] becomes the torch ``weight`` [out, in];
* a flax ``nn.Embed`` table ``embedding`` [num, dim] (the appearance
  embeddings ``appear_embed``, ``appear_embed_outside``) becomes the torch
  ``weight`` in the same layout;
* weight-norm ``g`` and ``bias`` keep their names and shapes;
* the per-level hash tables (a tuple under ``hash_table``: the SDF's, and
  each field's of Instant-NGP) become ``hash_table.<level>`` in the same
  dtype (bfloat16 included);
* the NeRF family's fields and the background NeRF keep their names
  (``nerf``, ``nerf_fine``, ``background_nerf``, each with ``mlp_feat`` and
  ``mlp_rgb``);
* scalars such as ``s_var`` stay 0-d;
* the radiance heads of every network mode (``mlp``, ``mlp_r``, ``mlp_s``,
  ``mlp_re``) keep their names.

``params_from_jax_checkpoint`` does the same for the params of a checkpoint
file the JAX package wrote (trainers/checkpoint.py reads the file), and
``opt_state_from_jax`` carries its optax optimizer state into the port's
optimizer (resuming a JAX run).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Sequence

import numpy as np
import torch


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of the port's model from a JAX param tree of numpy arrays."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif node is None:  # a frozen leaf of partial training's optimizer state
            return
        else:
            arr = np.asarray(node)
            if path[-1] == "kernel":
                path, arr = path[:-1] + ["weight"], arr.T
            elif path[-1] == "embedding":
                path = path[:-1] + ["weight"]
            out[".".join(path)] = _to_tensor(arr)

    walk(tree, [])
    return out


def params_from_jax_checkpoint(payload) -> Dict[str, torch.Tensor]:
    """State dict of the port's model from the payload of a JAX package
    checkpoint (``{"state": {"params": tree, ...}, ...}``)."""
    return params_from_jax(payload["state"]["params"])


def _kind(node) -> str:
    """An optax state's class name (a checkpoint's stand-in keeps it as ``kind``)."""
    return getattr(node, "kind", type(node).__name__)


def _find(node, kind: str):
    """The first optax state of ``kind`` in a chain's nested tuples, or None."""
    if _kind(node) == kind:
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find(child, kind)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, names: Sequence[str]) -> Dict[str, object]:
    """The port's optimizer state (``trainers/optim.py``: per-parameter
    lists in the order of ``names``) from the JAX package's optax state.

    Fields by position, as optax's NamedTuples define them:
    ``ScaleByAdamState(count, mu, nu)`` (AdamW, Adam, RAdam),
    ``TraceState(trace)`` with ``ScaleByScheduleState(count)`` (SGD), and
    ``MultiStepsState(mini_step, gradient_step, inner_opt_state, acc_grads,
    skip_state)`` around them under ``trainer.grad_accum_iter``; the
    ``lr_scales`` chain's ``MaskedState`` and the decay's ``EmptyState``
    hold nothing to carry."""

    def leaves(tree):
        state = params_from_jax(tree)
        return [state[n] for n in names]

    multi = _find(opt_state, "MultiStepsState")
    inner = multi[2] if multi is not None else opt_state
    adam = _find(inner, "ScaleByAdamState")
    if adam is not None:
        state = {"mu": leaves(adam[1]), "nu": leaves(adam[2]), "count": int(adam[0])}
    else:
        trace, sched = _find(inner, "TraceState"), _find(inner, "ScaleByScheduleState")
        if trace is None or sched is None:
            raise ValueError("the optax state holds neither ScaleByAdamState nor TraceState")
        state = {"trace": leaves(trace[0]), "count": int(sched[0])}
    if multi is not None:
        state = {"inner": state, "acc": [t.float() for t in leaves(multi[3])], "mini_step": int(multi[0]),
                 "gradient_step": int(multi[1])}
    return state
