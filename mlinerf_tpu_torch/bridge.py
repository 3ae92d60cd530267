"""Carry parameters from the JAX package's param tree into the port.

``params_from_jax`` takes the tree of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives and returns a state dict for the
port's modules, whose attribute names follow the tree:

* a flax ``kernel`` [in, out] becomes the torch ``weight`` [out, in];
* weight-norm ``g`` and ``bias`` keep their names and shapes;
* the per-level hash tables (a tuple under ``hash_table``) become
  ``hash_table.<level>`` in the same dtype (bfloat16 included);
* scalars such as ``s_var`` stay 0-d;
* the radiance heads of every network mode (``mlp``, ``mlp_r``, ``mlp_s``,
  ``mlp_re``) keep their names.

``params_from_jax_checkpoint`` does the same for the params of a checkpoint
file the JAX package wrote (trainers/checkpoint.py reads the file).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

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
        else:
            arr = np.asarray(node)
            if path[-1] == "kernel":
                path, arr = path[:-1] + ["weight"], arr.T
            out[".".join(path)] = _to_tensor(arr)

    walk(tree, [])
    return out


def params_from_jax_checkpoint(payload) -> Dict[str, torch.Tensor]:
    """State dict of the port's model from the payload of a JAX package
    checkpoint (``{"state": {"params": tree, ...}, ...}``)."""
    return params_from_jax(payload["state"]["params"])
