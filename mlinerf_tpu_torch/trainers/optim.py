"""The optimizers with optax's semantics, written as plain tensor code, the
parameter average (EMA) and the parameter partition of partial training.

``optim.type``: ``AdamW``; ``Adam`` and ``FusedAdam`` (``optax.adam``, which
is ``optax.adamw`` without the decay term: :class:`AdamW` with a weight
decay of exactly 0; any ``weight_decay`` in the config is dropped, as the
JAX package drops it); ``SGD`` and ``FusedSGD`` (``optax.sgd`` with
``params.momentum``, default 0); ``RAdam`` (``optax.radam``).
``trainer.grad_accum_iter`` k > 1 wraps the optimizer in
:class:`MultiSteps` (``optax.MultiSteps``).

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
* ``optim.lr_scales`` ({path keyword: s}) multiplies the update of each
  matching parameter by s, once per matching keyword in the config's order
  (optax.masked(optax.scale(s)) chained after the optimizer);
* the update is cast to the parameter's dtype before it is added.

An optimizer updates the tensors it was given in place: the parameters, or
under ``runtime.shard_tables`` a table's own rows (a view of them), with
moments of the same shape.

An update reads its per-step scalars (learning rate, bias corrections, the
accumulation count) from ``values``: :meth:`plan` gives them as float32-exact
Python floats for the j-th update from now, with a key for the host branch
the update takes, and :meth:`update` applies them, whether they arrive as
those floats or as 0-dim tensors of a device schedule table (a step captured
in a CUDA graph reads them so). :meth:`step` is plan, update and advance for
one step.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlinerf_tpu_torch.utils.misc import get_schedule


@functools.lru_cache(maxsize=4096)
def _round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a Python float that the dtype holds exactly)."""
    return torch.tensor(x, dtype=torch.float64).to(dtype).item()


def _pow_f32(x: float, n: int) -> np.float32:
    """``x ** n`` in float32 by repeated squaring, each product rounded: how
    XLA raises a float to an integer power (optax's ``decay ** count``)."""
    base, out = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            out = np.float32(out * base)
        base = np.float32(base * base)
        n >>= 1
    return out


def _scale(u: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    """``u`` times each ``optim.lr_scales`` factor, the factor rounded to
    ``u``'s dtype (optax.scale under JAX's weak typing)."""
    for scale in scales:
        u = u * _round_to(scale, u.dtype)
    return u


class _Optimizer:
    """The tensors an optimizer updates, its learning rate by update count,
    and per tensor the ``optim.lr_scales`` factors its update is multiplied
    by, in order."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], np.float32],
                 update_scales: Optional[Sequence[Sequence[float]]] = None):
        self.params: List[torch.Tensor] = list(params)
        self.lr_fn = lr_fn
        self.update_scales = [tuple(s) for s in update_scales] if update_scales else [()] * len(self.params)
        self.count = 0

    def values(self, count: int) -> Dict[str, float]:
        raise NotImplementedError

    def branch(self, count: int):
        """The host control flow of the update at ``count`` (None: one path)."""
        return None

    def plan(self, j: int = 0) -> Tuple[Dict[str, float], object]:
        """The scalars and the branch key of the ``j``-th update from now."""
        return self.values(self.count + j), self.branch(self.count + j)

    def advance(self, n: int = 1):
        self.count += n

    def step(self, grads: Sequence[torch.Tensor]):
        """Apply one update in place. ``grads`` align with ``params``."""
        values, key = self.plan(0)
        self.update(grads, values, key)
        self.advance(1)


class AdamW(_Optimizer):
    """optax-equivalent AdamW over a list of parameters."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], np.float32],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 update_scales: Optional[Sequence[Sequence[float]]] = None):
        super().__init__(params, lr_fn, update_scales)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
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

    def values(self, count: int) -> Dict[str, float]:
        """The step size at ``count`` and the bias corrections of the
        incremented count (the second rounded to each moment dtype)."""
        bc2 = float(np.float32(1.0 - self.b2 ** (count + 1)))
        out = {"lr": float(-self.lr_fn(count)), "bc1": float(np.float32(1.0 - self.b1 ** (count + 1)))}
        out.update({f"bc2.{dt}": _round_to(bc2, dt) for dt in _dtypes(self.nu)})
        return out

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], s, key=None):
        for p, g, mu, nu, scales in zip(self.params, grads, self.mu, self.nu, self.update_scales):
            c = self._constants(p.dtype)
            mu.mul_(self.b1).add_(g * c["1-b1"])  # float32; (1-b1)*g rounds in g's dtype
            nu.mul_(c["b2"]).add_(g * g * c["1-b2"])  # in the param dtype
            mu_hat = mu / s["bc1"]
            nu_hat = nu / s[f"bc2.{nu.dtype}"]
            u = mu_hat / (nu_hat.sqrt() + c["eps"])
            if self.weight_decay:
                u = u + p * c["wd"]
            u = _scale(u * s["lr"], scales)
            p.add_(u.to(p.dtype))

    def state_dict(self) -> Dict[str, object]:
        """``mu``, ``nu`` (CPU copies, in the order of ``params``) and ``count``."""
        return {"mu": [m.detach().cpu() for m in self.mu], "nu": [n.detach().cpu() for n in self.nu],
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]):
        _load_leaves(self.mu, state["mu"])
        _load_leaves(self.nu, state["nu"])
        self.count = int(state["count"])


class SGD(_Optimizer):
    """optax.sgd(lr, momentum): the trace ``t = g + momentum * t`` in the
    parameter's dtype, then ``lr`` rounded to the update's dtype times
    ``t`` (scale_by_learning_rate)."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], np.float32], momentum: float = 0.0,
                 update_scales: Optional[Sequence[Sequence[float]]] = None):
        super().__init__(params, lr_fn, update_scales)
        self.momentum = momentum
        self.trace = [torch.zeros_like(p) for p in self.params]

    def values(self, count: int) -> Dict[str, float]:
        step_size = float(-self.lr_fn(count))
        return {f"lr.{dt}": _round_to(step_size, dt) for dt in _dtypes(self.trace)}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], s, key=None):
        for p, g, t, scales in zip(self.params, grads, self.trace, self.update_scales):
            t.mul_(_round_to(self.momentum, t.dtype)).add_(g)
            u = _scale(t * s[f"lr.{t.dtype}"], scales)
            p.add_(u.to(p.dtype))

    def state_dict(self) -> Dict[str, object]:
        return {"trace": [t.detach().cpu() for t in self.trace], "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]):
        _load_leaves(self.trace, state["trace"])
        self.count = int(state["count"])


class RAdam(_Optimizer):
    """optax.radam(lr, b1, b2, eps, threshold=5): both moments in the
    parameter's dtype (the JAX package drops ``mu_dtype`` for it); the
    rectification ``r`` and ``rho`` in float32 from the incremented count;
    while ``rho`` is below the threshold the update is the bias-corrected
    first moment (optax's threshold, not ``torch.optim.RAdam``'s)."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], np.float32],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, threshold: float = 5.0,
                 update_scales: Optional[Sequence[Sequence[float]]] = None):
        super().__init__(params, lr_fn, update_scales)
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _rho(self, count: int):
        """(rho, b2 ** count) of the incremented count, in float32."""
        f32 = np.float32
        b2t = _pow_f32(self.b2, count)
        # rho_inf - rho is a difference of nearly equal numbers: b2 ** count
        # must round as optax's does.
        return f32(2.0 / (1.0 - self.b2) - 1.0) - f32(2 * count) * b2t / (f32(1.0) - b2t), b2t

    def branch(self, count: int) -> bool:
        """Whether the update at ``count`` is rectified (rho at the threshold or above)."""
        return bool(self._rho(count + 1)[0] >= self.threshold)

    def values(self, count: int) -> Dict[str, float]:
        """Per parameter dtype: the step size, both bias corrections and the
        rectification ``r`` (NaN while rho is below 4; then unread), each
        rounded to that dtype."""
        f32 = np.float32
        step_size = float(-self.lr_fn(count))
        count += 1
        rho_inf = 2.0 / (1.0 - self.b2) - 1.0
        rho, b2t = self._rho(count)
        with np.errstate(invalid="ignore"):
            r = np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
                        / (f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho))
        bc1, bc2 = f32(1.0) - _pow_f32(self.b1, count), f32(1.0) - b2t
        out = {}
        for dt in _dtypes(self.params):
            out.update({f"lr.{dt}": _round_to(step_size, dt), f"bc1.{dt}": _round_to(float(bc1), dt),
                        f"bc2.{dt}": _round_to(float(bc2), dt), f"r.{dt}": _round_to(float(r), dt)})
        return out

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], s, key=None):
        for p, g, mu, nu, scales in zip(self.params, grads, self.mu, self.nu, self.update_scales):
            dt = p.dtype
            mu.copy_(g * _round_to(1 - self.b1, dt) + mu * _round_to(self.b1, dt))
            nu.copy_((g * g) * _round_to(1 - self.b2, dt) + nu * _round_to(self.b2, dt))
            mu_hat = mu / s[f"bc1.{dt}"]
            if key:
                nu_hat = nu / s[f"bc2.{dt}"]
                u = s[f"r.{dt}"] * mu_hat / (nu_hat.sqrt() + _round_to(self.eps, dt))
            else:
                u = mu_hat
            u = _scale(u * s[f"lr.{u.dtype}"], scales)
            p.add_(u.to(p.dtype))

    # The same state as AdamW's: mu, nu and count.
    state_dict = AdamW.state_dict
    load_state_dict = AdamW.load_state_dict


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k): each step adds its
    gradient to a running mean (``acc + (g - acc) / (n + 1)``, float32);
    the k-th step hands the mean, in each gradient's dtype, to the inner
    optimizer and starts a new mean. The other steps leave the parameters
    as they are. (optax keeps a bfloat16 leaf's mean in bfloat16 for the
    first step and in float32 after it, and then refuses its own state at
    the second step; the port keeps every mean in float32.)"""

    def __init__(self, inner, k: int):
        self.inner, self.k = inner, k
        self.params = inner.params
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.mini_step = 0
        self.gradient_step = 0

    @property
    def count(self) -> int:
        return self.inner.count

    def plan(self, j: int = 0):
        """The running mean's divisor ``n + 1`` and the inner update's
        scalars; the key says whether the step hands the mean on (with the
        inner update's own key)."""
        n = (self.mini_step + j) % self.k
        inner_values, inner_key = self.inner.plan((self.mini_step + j) // self.k)
        values = {"n+1": float(n + 1), **{f"inner.{k}": v for k, v in inner_values.items()}}
        return values, (n == self.k - 1, inner_key if n == self.k - 1 else None)

    def advance(self, n: int = 1):
        for _ in range(n):
            if self.mini_step == self.k - 1:
                self.inner.advance(1)
                self.gradient_step += 1
            self.mini_step = (self.mini_step + 1) % self.k

    step = _Optimizer.step

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], s, key):
        for acc, g in zip(self.acc, grads):
            acc.add_((g.float() - acc) / s["n+1"])
        if key[0]:
            inner = {k[len("inner."):]: v for k, v in s.items() if k.startswith("inner.")}
            self.inner.update([acc.to(g.dtype) for acc, g in zip(self.acc, grads)], inner, key[1])
            for acc in self.acc:
                acc.zero_()

    def state_dict(self) -> Dict[str, object]:
        return {"inner": self.inner.state_dict(), "acc": [a.detach().cpu() for a in self.acc],
                "mini_step": self.mini_step, "gradient_step": self.gradient_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]):
        self.inner.load_state_dict(state["inner"])
        _load_leaves(self.acc, state["acc"])
        self.mini_step, self.gradient_step = int(state["mini_step"]), int(state["gradient_step"])


def _dtypes(tensors: Sequence[torch.Tensor]) -> List[torch.dtype]:
    """The distinct dtypes of ``tensors``, in order of first appearance."""
    return list(dict.fromkeys(t.dtype for t in tensors))


def _load_leaves(mine: Sequence[torch.Tensor], theirs: Sequence[torch.Tensor]):
    if len(mine) != len(theirs):
        raise ValueError(f"optimizer state for {len(theirs)} leaves, this optimizer has {len(mine)}")
    for m, t in zip(mine, theirs):
        m.copy_(t)


def make_optimizer(cfg_optim, params: Sequence[torch.Tensor], names: Optional[Sequence[str]] = None,
                   max_iter: Optional[int] = None, grad_accum: int = 1):
    """The ``optim`` config's optimizer over ``params`` and its LR function
    (the learning rate at an outer iteration, for logging). ``names`` (the
    parameters' dotted names) select the leaves of ``optim.lr_scales``;
    ``max_iter`` is the schedules' default horizon. With ``grad_accum`` k >
    1 the optimizer is wrapped in :class:`MultiSteps` and its schedule is
    indexed by ``k * updates``, so it follows the outer iteration."""
    name = cfg_optim.type.lower()
    lr_scales = dict(cfg_optim.get("lr_scales") or {})
    update_scales = None
    if lr_scales:
        if names is None:
            raise ValueError("optim.lr_scales needs the parameters' names")
        update_scales = [[float(s) for kw, s in lr_scales.items() if param_path_matches(name, [kw])]
                         for name in names]
    params_cfg = dict(cfg_optim.get("params", {}))
    base_lr = np.float32(params_cfg.pop("lr", 1e-3))
    sched_fn = get_schedule(cfg_optim.get("sched", {"type": "constant"}), max_iter=max_iter)
    grad_accum = max(int(grad_accum or 1), 1)

    def lr_fn(step: int) -> np.float32:
        return base_lr * sched_fn(step)

    def inner_lr_fn(count: int) -> np.float32:
        return lr_fn(count * grad_accum)

    kwargs = {}
    if "betas" in params_cfg:
        kwargs["b1"], kwargs["b2"] = params_cfg.pop("betas")
    if "eps" in params_cfg:
        kwargs["eps"] = params_cfg.pop("eps")
    if name in ("adamw", "adam", "fusedadam"):
        kwargs["weight_decay"] = params_cfg.pop("weight_decay", 1e-4) if name == "adamw" else 0.0
        opt = AdamW(params, inner_lr_fn, update_scales=update_scales, **kwargs)
    elif name in ("sgd", "fusedsgd"):
        opt = SGD(params, inner_lr_fn, momentum=float(params_cfg.pop("momentum", 0.0)), update_scales=update_scales)
    elif name == "radam":
        opt = RAdam(params, inner_lr_fn, update_scales=update_scales, **kwargs)
    else:
        raise NotImplementedError(f"Unknown optimizer {cfg_optim.type}")
    return (MultiSteps(opt, grad_accum) if grad_accum > 1 else opt), lr_fn


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


def global_norm(tensors: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (0 for no
    tensor, on ``device``)."""
    return torch.sqrt(sum((torch.sum(t.float() ** 2) for t in tensors), torch.zeros((), device=device)))


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
