"""Configuration: YAML with ``_parent_`` inheritance, strict dot-path CLI
overrides, and a string -> class registry.

The port's own copy of the JAX package's config module (the port imports
nothing of that package). The semantics are the same: attribute-style
access, recursive merge, ``--a.b=v`` / ``--a.b`` (True) / ``--a.b!`` (False)
overrides where unknown keys are errors, and a float resolver that accepts
``5e-4``. The registry resolves names to the port's classes.
"""

from __future__ import annotations

import copy
import importlib
import os
import re
from typing import Any, Callable, Dict, List, Optional

import yaml


class AttrDict(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for key, value in list(self.items()):
            self[key] = self._wrap(value)

    @staticmethod
    def _wrap(value):
        # Always plain AttrDict: Config's constructor takes a filename.
        if isinstance(value, AttrDict):
            return value
        if isinstance(value, dict):
            return AttrDict(value)
        if isinstance(value, (list, tuple)):
            return [AttrDict._wrap(v) for v in value]
        return value

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value):
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def __deepcopy__(self, memo):
        return type(self)({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self.items():
            if isinstance(value, AttrDict):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, AttrDict) else v for v in value]
            else:
                out[key] = value
        return out


def _yaml_loader():
    """A SafeLoader whose float resolver accepts ``5e-4``-style notation."""
    loader = yaml.SafeLoader
    loader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:
             [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return loader


def recursive_update(dst: AttrDict, src: dict) -> AttrDict:
    """Merge ``src`` into ``dst`` in place (src wins), recursing into dicts."""
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            recursive_update(dst[key], value)
        else:
            dst[key] = value
    return dst


def recursive_update_strict(dst: AttrDict, src: dict, _stack: Optional[List[str]] = None) -> AttrDict:
    """Like :func:`recursive_update` but unknown keys raise ``KeyError``."""
    _stack = _stack or []
    for key, value in src.items():
        if key not in dst:
            raise KeyError(f"Unknown config key: {'.'.join(_stack + [str(key)])}")
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            recursive_update_strict(dst[key], value, _stack + [str(key)])
        else:
            dst[key] = value
    return dst


def load_yaml_with_parents(filename: str, _seen: Optional[set] = None) -> AttrDict:
    """Load a YAML file, recursively resolving its ``_parent_`` chain.

    Parent paths resolve relative to the child file's directory first, then
    relative to the current working directory.
    """
    _seen = _seen or set()
    filename = os.path.abspath(filename)
    if filename in _seen:
        raise ValueError(f"Cyclic _parent_ chain at {filename}")
    _seen.add(filename)
    with open(filename) as f:
        cfg = yaml.load(f, Loader=_yaml_loader()) or {}
    cfg = AttrDict(cfg)
    parent = cfg.pop("_parent_", None)
    if parent is not None:
        for cand in (os.path.join(os.path.dirname(filename), parent), parent):
            if os.path.exists(cand):
                parent_path = cand
                break
        else:
            raise FileNotFoundError(f"_parent_ '{parent}' of {filename} not found")
        base = load_yaml_with_parents(parent_path, _seen)
        recursive_update(base, cfg)
        cfg = base
    return cfg


_DEFAULTS_FILE = os.path.join(os.path.dirname(__file__), "config_base.yaml")


class Config(AttrDict):
    """Full experiment configuration.

    Merge order: built-in ``config_base.yaml`` -> user YAML (via its
    ``_parent_`` chain) -> CLI overrides (strict).
    """

    def __init__(self, filename: Optional[str] = None, cli_args: Optional[List[str]] = None):
        super().__init__()
        recursive_update(self, load_yaml_with_parents(_DEFAULTS_FILE))
        if filename is not None:
            recursive_update(self, load_yaml_with_parents(filename))
        self["source_filename"] = filename
        if cli_args:
            recursive_update_strict(self, parse_cmdline_arguments(cli_args))

    def save_config(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "config.yaml"), "w") as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False, indent=4)


def parse_cmdline_arguments(args: List[str]) -> Dict[str, Any]:
    """Parse ``--key1.key2=value`` overrides.

      ``--a.b.c=value`` -> parsed with YAML semantics
      ``--a.b.c=``      -> None
      ``--a.b.c``       -> True
      ``--a.b.c!``      -> False
    """
    out: Dict[str, Any] = {}
    for arg in args:
        if not arg.startswith("--"):
            raise ValueError(f"Config overrides must start with '--': {arg}")
        body = arg[2:]
        if "=" not in body:
            key_str, value = (body[:-1], "false") if body.endswith("!") else (body, "true")
        else:
            key_str, value = body.split("=", 1)
        node = out
        keys = key_str.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] in node:
            raise ValueError(f"Duplicate override for {key_str}")
        node[keys[-1]] = yaml.safe_load(value) if value != "" else None
    return out


# ---------------------------------------------------------------------------
# Registry: string -> class.
# ---------------------------------------------------------------------------

_REGISTRIES: Dict[str, Dict[str, Any]] = {"model": {}, "trainer": {}, "dataset": {}}

_BUILTIN_MODULES = {
    "model": ["mlinerf_tpu_torch.models.neuralangelo", "mlinerf_tpu_torch.models.lumen"],
    "trainer": ["mlinerf_tpu_torch.trainers.neuralangelo", "mlinerf_tpu_torch.trainers.lumen"],
    "dataset": ["mlinerf_tpu_torch.data.synthetic"],
}


def register(kind: str, name: str) -> Callable:
    """Class decorator: ``@register("model", "lumen")``."""

    def deco(cls):
        _REGISTRIES[kind][name] = cls
        return cls

    return deco


def resolve(kind: str, name: str):
    """Resolve a registry name to the port's class."""
    for mod in _BUILTIN_MODULES[kind]:
        importlib.import_module(mod)
    reg = _REGISTRIES[kind]
    if name not in reg:
        raise NotImplementedError(
            f"{kind} type '{name}' is not ported to mlinerf_tpu_torch "
            f"(ported: {sorted(reg)})")
    return reg[name]
