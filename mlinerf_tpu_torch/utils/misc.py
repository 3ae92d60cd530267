"""Small shared utilities: device selection, the float32 matmul guard,
activations, LR schedules.

Schedules map an iteration count to a multiplier on the base learning rate.
They run on the host in float32 arithmetic (numpy scalars), the precision
the JAX package evaluates them in, so both packages step with the same
learning rate to the last bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F


def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Asking for CUDA on a machine without it raises; nothing falls back
    to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return device


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 on the card (TF32 off) inside the block;
    the previous setting is restored after it."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def require_ported(ok: bool, key: str):
    """Raise NotImplementedError naming the config key of a branch the port
    does not carry."""
    if not ok:
        raise NotImplementedError(f"{key}: this branch is not ported to mlinerf_tpu_torch")


def get_activation(name: str, **kwargs) -> Callable:
    """Activation by name. Softplus with ``beta`` is ``softplus(beta*x)/beta``,
    the JAX package's formula (``F.softplus``'s own ``beta`` argument is not
    used, so both packages round the same intermediate)."""
    table = {
        "identity": lambda x: x,
        "relu": F.relu,
        "relu_": F.relu,
        "abs": torch.abs,
        "abs_": torch.abs,
        "sigmoid": torch.sigmoid,
        "sigmoid_": torch.sigmoid,
        "exp": torch.exp,
        "exp_": torch.exp,
        "softplus": F.softplus,
        "silu": F.silu,
        "silu_": F.silu,
    }
    fn = table[name]
    if name == "softplus" and "beta" in kwargs:
        beta = float(kwargs["beta"])
        return lambda x: F.softplus(x * beta) / beta
    return fn


# ---------------------------------------------------------------------------
# LR schedules: iteration -> np.float32 multiplier on the base LR.
# ---------------------------------------------------------------------------


def schedule_two_steps_with_warmup(warm_up_end: int, two_steps, gamma: float):
    s0, s1 = two_steps

    def sch(x):
        x = np.float32(x)
        if x < warm_up_end:
            return x / np.float32(warm_up_end)
        if x > s1:
            return np.float32(1.0 / gamma**2)
        if x > s0:
            return np.float32(1.0 / gamma)
        return np.float32(1.0)

    return sch


def schedule_step(step_size: int, gamma: float):
    def sch(x):
        return np.float32(gamma) ** np.floor(np.float32(x) / np.float32(step_size))

    return sch


def get_schedule(cfg_sched) -> Callable:
    """Build a schedule callable from an ``optim.sched`` config node."""
    stype = cfg_sched.get("type", "step")
    if stype == "two_steps_with_warmup":
        return schedule_two_steps_with_warmup(cfg_sched.warm_up_end, cfg_sched.two_steps, cfg_sched.gamma)
    if stype == "step":
        return schedule_step(cfg_sched.get("step_size", 10**10), cfg_sched.get("gamma", 1.0))
    raise NotImplementedError(f"optim.sched.type '{stype}' is not ported")
