"""AdamW and Adam with optax's semantics, written as plain tensor code, the
parameter average (EMA) and the parameter partition of partial training.

``optim.type: Adam`` (and ``FusedAdam``) is ``optax.adam``, which is
``optax.adamw`` without the decay term: :class:`AdamW` with a weight decay
of exactly 0 (any ``weight_decay`` in the config is dropped, as the JAX
package drops it).

``optax.adamw(lr_schedule, b1, b2, eps, weight_decay, mu_dtype=float32)``
is scale_by_adam -> add_decayed_weights -> scale_by_learning_rate. What the
JAX package's training relies on, and this keeps:

* ``mu`` is float32 (``mu_dtype``); ``nu`` is kept in the parameter's dtype,
  so bfloat16 for the hash tables;
* every scalar meets a tensor in that tensor's dtype (JAX's weak typing
  rounds ``1 - b1``, ``b2``, ``eps`` and the weight decay to bfloat16 for a
  bfloat16 leaf), and each elementwise step rounds where optax's does;
* the bias corrections use the incremented count, the learning rate the
  count before the update (so the first update has ``lr(0)``);
* decoupled weight decay applies to every leaf;
* ``optim.lr_scales`` ({path keyword: s}) multiplies the float32 update
  of each matching parameter by s, once per matching keyword in the
  config's order (optax.masked(optax.scale(s)) chained after AdamW);
* the update is cast to the parameter's dtype before it is added.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlinerf_tpu_torch.utils.misc import get_schedule


def _round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a Python float that the dtype holds exactly)."""
    return torch.tensor(x, dtype=torch.float64).to(dtype).item()


class AdamW:
    """optax-equivalent AdamW over a list of parameters."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], np.float32],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 update_scales: Optional[Sequence[Sequence[float]]] = None):
        self.params: List[torch.Tensor] = list(params)
        self.lr_fn = lr_fn
        # Per parameter, the factors its update is multiplied by, in order.
        self.update_scales = [tuple(s) for s in update_scales] if update_scales else [()] * len(self.params)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self._consts: Dict[torch.dtype, Dict[str, float]] = {}

    def _constants(self, dtype: torch.dtype) -> Dict[str, float]:
        if dtype not in self._consts:
            self._consts[dtype] = {
                "1-b1": _round_to(1 - self.b1, dtype),
                "1-b2": _round_to(1 - self.b2, dtype),
                "b2": _round_to(self.b2, dtype),
                "eps": _round_to(self.eps, dtype),
                "wd": _round_to(self.weight_decay, dtype),
            }
        return self._consts[dtype]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        """Apply one update in place. ``grads`` align with ``params``."""
        step_size = float(-self.lr_fn(self.count))
        count = self.count + 1
        bc1 = float(np.float32(1.0 - self.b1**count))
        bc2 = np.float32(1.0 - self.b2**count)
        for p, g, mu, nu, scales in zip(self.params, grads, self.mu, self.nu, self.update_scales):
            c = self._constants(p.dtype)
            mu.mul_(self.b1).add_(g * c["1-b1"])  # float32; (1-b1)*g rounds in g's dtype
            nu.mul_(c["b2"]).add_(g * g * c["1-b2"])  # in the param dtype
            mu_hat = mu / bc1
            nu_hat = nu / _round_to(float(bc2), nu.dtype)
            u = mu_hat / (nu_hat.sqrt() + c["eps"])
            if self.weight_decay:
                u = u + p * c["wd"]
            u = u * step_size
            for scale in scales:
                u = u * scale
            p.add_(u.to(p.dtype))
        self.count = count

    def state_dict(self) -> Dict[str, object]:
        """``mu``, ``nu`` (CPU copies, in the order of ``params``) and ``count``."""
        return {"mu": [m.detach().cpu() for m in self.mu], "nu": [n.detach().cpu() for n in self.nu],
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]):
        if not len(state["mu"]) == len(state["nu"]) == len(self.params):
            raise ValueError(f"optimizer state for {len(state['mu'])} leaves, this model has {len(self.params)}")
        for mine, theirs in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            mine.copy_(theirs)
        self.count = int(state["count"])


def make_optimizer(cfg_optim, params: Sequence[torch.Tensor],
                   names: Optional[Sequence[str]] = None) -> Tuple[AdamW, Callable[[int], np.float32]]:
    """The ``optim`` config's AdamW or Adam over ``params`` and its LR function.
    ``names`` (the parameters' dotted names) select the leaves of
    ``optim.lr_scales``."""
    name = cfg_optim.type.lower()
    if name not in ("adamw", "adam", "fusedadam"):
        raise NotImplementedError(f"optim.type '{cfg_optim.type}' is not ported (AdamW and Adam are)")
    lr_scales = dict(cfg_optim.get("lr_scales") or {})
    update_scales = None
    if lr_scales:
        if names is None:
            raise ValueError("optim.lr_scales needs the parameters' names")
        update_scales = [[float(s) for kw, s in lr_scales.items() if param_path_matches(name, [kw])]
                         for name in names]
    params_cfg = dict(cfg_optim.get("params", {}))
    base_lr = np.float32(params_cfg.pop("lr", 1e-3))
    sched_fn = get_schedule(cfg_optim.sched)

    def lr_fn(step: int) -> np.float32:
        return base_lr * sched_fn(step)

    kwargs = {}
    if "weight_decay" in params_cfg:
        kwargs["weight_decay"] = params_cfg.pop("weight_decay")
    if name != "adamw":
        kwargs["weight_decay"] = 0.0
    if "betas" in params_cfg:
        kwargs["b1"], kwargs["b2"] = params_cfg.pop("betas")
    if "eps" in params_cfg:
        kwargs["eps"] = params_cfg.pop("eps")
    return AdamW(params, lr_fn, update_scales=update_scales, **kwargs), lr_fn


@torch.no_grad()
def ema_update(avg_params: Sequence[torch.Tensor], new_params: Sequence[torch.Tensor], beta: float):
    """The exponential moving average ``avg = avg * beta + new * (1 - beta)``,
    in place, in each leaf's own dtype, as the JAX package computes it:
    ``beta`` and ``1 - beta`` are rounded to the leaf's dtype (JAX's weak
    typing; for bfloat16, 0.999 rounds to 1.0) and each product and the
    sum round to it."""
    consts = {}
    for a, p in zip(avg_params, new_params):
        if a.dtype not in consts:
            consts[a.dtype] = (_round_to(beta, a.dtype), _round_to(1.0 - beta, a.dtype))
        keep, take = consts[a.dtype]
        a.mul_(keep).add_(p * take)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (0 for no tensor)."""
    return torch.sqrt(sum((torch.sum(t.float() ** 2) for t in tensors), torch.zeros(())))


# ---------------------------------------------------------------------------
# Partial training (stage b trains the radiance heads only)
# ---------------------------------------------------------------------------


def param_path_matches(name: str, keywords: Sequence[str]) -> bool:
    """True when any keyword is a substring of the parameter's path. The
    port's dotted name is compared as the JAX package's '/'-joined path
    (``neural_rgb.mlp.linear_0.weight`` as ``neural_rgb/mlp/linear_0/weight``),
    so the same keywords select the same leaves."""
    joined = name.replace(".", "/")
    return any(kw in joined for kw in keywords)


def trainable_mask(named_params: Iterable[Tuple[str, torch.Tensor]], keywords: Sequence[str]) -> List[bool]:
    """One bool per (name, parameter): True where the name matches a keyword."""
    return [param_path_matches(name, keywords) for name, _ in named_params]


def partition_params(named_params: Iterable[Tuple[str, torch.Tensor]], keywords: Sequence[str]):
    """Split (name, parameter) pairs into (trainable, frozen) lists of pairs."""
    named_params = list(named_params)
    mask = trainable_mask(named_params, keywords)
    trainable = [pair for pair, m in zip(named_params, mask) if m]
    frozen = [pair for pair, m in zip(named_params, mask) if not m]
    return trainable, frozen
