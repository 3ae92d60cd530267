"""MLP building blocks: weight-normalized linear layers, a plain MLP with
skip connections, the SDF MLP with geometric initialization, and the
re-initialization of ``trainer.init.type``.

Parameter names follow the JAX package's tree (``linear_{i}`` with
``weight``/``bias``/``g``; ``linear_sdf``), with torch's [out, in] weight
layout, so ``bridge.params_from_jax`` maps one onto the other.

Mixed precision (``compute_dtype``, bf16 under ``trainer.amp_config``) is
written out as the JAX package computes it: the parameters stay float32,
the input, the weight and the bias are cast to the compute dtype, the
product is rounded to it and the bias is added in it. ``torch.autocast``
would keep another set of ops in float32.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

KernelInit = Callable[[torch.Generator, int, int], torch.Tensor]


def lecun_normal(generator: torch.Generator, out_features: int, in_features: int) -> torch.Tensor:
    """Truncated normal (+-2 std) with variance 1/fan_in, as flax's default."""
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    w = torch.empty(out_features, in_features)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class WNDense(nn.Module):
    """Linear layer with optional weight normalization.

    With weight norm the effective weight is ``g * v / (||v|| + 1e-12)``,
    the norm taken over each output unit's fan-in, and ``g`` starts at
    ``||v|| + 1e-12`` so the initial function is the raw init's.
    """

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator,
                 use_weightnorm: bool = False, kernel_init: KernelInit = lecun_normal,
                 bias_value: float = 0.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_weightnorm = use_weightnorm
        self.compute_dtype = compute_dtype
        weight = kernel_init(generator, out_features, in_features)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_value)))
        if use_weightnorm:
            self.g = nn.Parameter(torch.linalg.vector_norm(weight, dim=1) + 1e-12)

    def forward(self, x):
        w = self.weight
        if self.use_weightnorm:
            norm = torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-12
            w = self.g[:, None] * w / norm
        if self.compute_dtype == torch.float32:
            return F.linear(x, w, self.bias)
        cd = self.compute_dtype
        return torch.matmul(x.to(cd), w.to(cd).t()) + self.bias.to(cd)


_TRUNC_NORMAL_STD = 0.87962566103423978  # std of a standard normal cut at +-2


def dense_kernel_init(kind: str, fan_in: int, fan_out: int, gain: float, generator: torch.Generator) -> torch.Tensor:
    """A [fan_in, fan_out] kernel drawn as flax's initializers draw it
    (``trainer.init.type``): ``normal`` (std 0.02 * gain), ``xavier`` and
    ``xavier_uniform`` (variance_scaling(gain, fan_avg, truncated normal /
    uniform)), ``kaiming`` (variance_scaling(2 * gain, fan_in, normal)) and
    ``orthogonal`` (scale gain; orthonormal columns, or rows where fan_in <
    fan_out). float32, from ``generator``."""
    shape = (fan_in, fan_out)
    if kind == "normal":
        return torch.randn(shape, generator=generator) * (0.02 * gain)
    if kind == "orthogonal":
        tall = fan_in >= fan_out
        a = torch.randn(shape if tall else shape[::-1], generator=generator, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None]
        return (gain * (q if tall else q.T)).float()
    scale, fan = {"xavier": (gain, (fan_in + fan_out) / 2), "xavier_uniform": (gain, (fan_in + fan_out) / 2),
                  "kaiming": (2.0 * gain, fan_in)}.get(kind, (None, None))
    if scale is None:
        raise NotImplementedError(f"Unknown init type {kind}")
    variance = scale / fan
    if kind == "xavier":
        w = nn.init.trunc_normal_(torch.empty(shape), std=1.0, a=-2.0, b=2.0, generator=generator)
        return w * (math.sqrt(variance) / _TRUNC_NORMAL_STD)
    if kind == "xavier_uniform":
        return (torch.rand(shape, generator=generator) * 2 - 1) * math.sqrt(3 * variance)
    return torch.randn(shape, generator=generator) * math.sqrt(variance)


@torch.no_grad()
def reinit_dense_weights(model: nn.Module, kind: str, gain: float, generator: torch.Generator) -> List[str]:
    """Draw every dense layer's weight anew (the JAX package's
    ``_apply_weight_init``: every 2-D ``kernel``; biases, weight-norm ``g``,
    embeddings and hash tables keep theirs). Returns the weights' names."""
    names = []
    for name, module in model.named_modules():
        if isinstance(module, WNDense):
            w = module.weight
            kernel = dense_kernel_init(kind, w.shape[1], w.shape[0], gain, generator)
            w.copy_(kernel.T.to(w.dtype))
            names.append(f"{name}.weight")
    return names


class MLPwithSkipConnection(nn.Module):
    """Plain MLP with input re-concatenation at the given layer indices.
    ``layer_dims`` lists channels including input and output; there is no
    activation after the last layer."""

    def __init__(self, layer_dims: Sequence[int], generator: torch.Generator,
                 skip_connection: Sequence[int] = (), activ: Callable = F.relu,
                 use_weightnorm: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_connection = tuple(skip_connection)
        self.activ = activ
        self.num_layers = len(layer_dims) - 1
        for li in range(self.num_layers):
            k_in = layer_dims[li] + (layer_dims[0] if li in self.skip_connection else 0)
            self.add_module(f"linear_{li}", WNDense(k_in, layer_dims[li + 1], generator,
                                                    use_weightnorm=use_weightnorm, compute_dtype=compute_dtype))

    def forward(self, x):
        feat = x
        for li in range(self.num_layers):
            if li in self.skip_connection:
                feat = torch.cat([feat, x.to(feat.dtype)], dim=-1)
            feat = getattr(self, f"linear_{li}")(feat)
            if li != self.num_layers - 1:
                feat = self.activ(feat)
        return feat


def _geometric_hidden_init(first: bool, skip_dim: int) -> KernelInit:
    """weight ~ N(0, 2/k_out); the first layer reads only xyz (encoding
    columns zeroed); skip-connection columns are zeroed."""

    def init(generator, k_out, k_in):
        w = torch.randn(k_out, k_in, generator=generator) * math.sqrt(2.0 / k_out)
        if first:
            w[:, 3:] = 0.0
        if skip_dim:
            w[:, -skip_dim:] = 0.0
        return w

    return init


def _geometric_sdf_head_init(invert: bool) -> KernelInit:
    def init(generator, k_out, k_in):
        w = torch.randn(k_out, k_in, generator=generator) * 1e-4 + math.sqrt(math.pi / k_in)
        return -w if invert else w

    return init


class MLPforNeuralSDF(nn.Module):
    """SDF MLP: a linear SDF head reads the input of the last layer; every
    layer (the last included) is followed by the activation. Geometric
    initialization starts the SDF as a sphere of radius ``out_bias``.
    Returns (sdf [...,1] float32 or None, feat [...,K] in the compute dtype
    or None): the SDF comes back to float32 for the NeuS math."""

    def __init__(self, layer_dims: Sequence[int], generator: torch.Generator,
                 skip_connection: Sequence[int] = (), activ: Callable = F.softplus,
                 use_weightnorm: bool = False, geometric_init: bool = True,
                 out_bias: float = 0.5, invert: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_connection = tuple(skip_connection)
        self.activ = activ
        self.num_layers = len(layer_dims) - 1
        k_in = layer_dims[0]
        for li in range(self.num_layers):
            skip_dim = layer_dims[0] if li in self.skip_connection else 0
            k_in = layer_dims[li] + skip_dim
            kinit = (_geometric_hidden_init(first=(li == 0), skip_dim=skip_dim)
                     if geometric_init else lecun_normal)
            self.add_module(f"linear_{li}", WNDense(k_in, layer_dims[li + 1], generator,
                                                    use_weightnorm=use_weightnorm, kernel_init=kinit,
                                                    compute_dtype=compute_dtype))
        if geometric_init:
            sdf_init = _geometric_sdf_head_init(invert)
            sdf_bias = -out_bias * (-1 if invert else 1)
        else:
            sdf_init, sdf_bias = lecun_normal, 0.0
        # k_in is the last layer's input width, which the SDF head reads.
        self.linear_sdf = WNDense(k_in, 1, generator, use_weightnorm=use_weightnorm,
                                  kernel_init=sdf_init, bias_value=sdf_bias, compute_dtype=compute_dtype)

    def forward(self, x, with_sdf: bool = True, with_feat: bool = True):
        feat = x
        sdf_in: Optional[torch.Tensor] = None
        for li in range(self.num_layers):
            if li in self.skip_connection:
                feat = torch.cat([feat, x.to(feat.dtype)], dim=-1)
            if li == self.num_layers - 1:
                sdf_in = feat
            if li != self.num_layers - 1 or with_feat:
                feat = self.activ(getattr(self, f"linear_{li}")(feat))
        sdf = self.linear_sdf(sdf_in).float() if with_sdf else None
        return sdf, (feat if with_feat else None)
