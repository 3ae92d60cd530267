"""Nested-dict array stores for the pseudo-label artifacts (``results_all``,
``pseudo_label_all``), in the JAX package's ``.npz`` layout: keys are joined
with ``||`` into one compressed npz, and ``load_results_all`` rebuilds the
nesting. The JAX package's pseudo-label pipeline reads these files as they
are."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

_SEP = "||"


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_results_all(results: Dict[str, Any], path: str):
    """Save a nested dict of arrays to ``path`` (``.npz`` is appended)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_flatten(results))


def load_results_all(path: str) -> Dict[str, Any]:
    """Load a nested dict store written by :func:`save_results_all`."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
