"""Multiresolution hash-grid encoding.

Levels whose dense grid fits the table are indexed densely
(``ix + R*(iy + R*iz)``); larger levels use the Instant-NGP spatial hash
``ix ^ iy*2654435761 ^ iz*805459861 (mod T)`` with uint32 wrap-around. Each
level is its own table (a separate parameter), so each level's gradient is a
buffer of that level's size. The 8-corner gather of a level goes through
``hashgrid_scatter.take_rows``, whose backward is the hand-written CUDA
scatter-add on the card.

Each level's features are computed in float32 from the table's values and
rounded to the table's dtype; levels are concatenated in that dtype and the
caller casts the result.

Three variants of the JAX package's fast path, each selected by config:

* ``encode_stencil`` evaluates a point and its numerical-gradient taps in
  one pass; levels below ``shared_levels`` gather the centre's 8 corners
  once for all of them (one table-gradient scatter per level instead of
  one per evaluation), each evaluation weighting them with its own
  unclamped, extrapolated trilinear weights.
* ``dense_blocked``: a dense level is read through a per-cell block table
  ``[(res-1)^3, 8F]`` made of 8 shifted slices of the grid, so a point
  gathers one row of 8F values and its backward scatters one row; the
  slices' backward is dense adds, with no scatter.
* ``CornerSampling``: the forward stays exact; the backward scatters 1 (or
  1 + k) corner rows per point, drawn by an unbiased importance sampler
  (:class:`CornerSampledCombine`).

Every table gradient goes through ``hashgrid_scatter.scatter_add_rows``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlinerf_tpu_torch.ops import hashgrid_scatter
from mlinerf_tpu_torch.ops.hashgrid_scatter import take_rows

# Primes of the Instant-NGP spatial hash (first coordinate unhashed).
_PRIMES = (1, 2654435761, 805459861)
_UINT32_MASK = 0xFFFFFFFF

gathers = 0  # table-row gathers by the encoder (one per level lookup), on any device


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multiresolution hash encoding."""

    num_levels: int = 16
    features_per_level: int = 8
    log2_hashmap_size: int = 22
    min_logres: int = 5
    max_logres: int = 11
    range_min: float = -2.0
    range_max: float = 2.0
    dtype: str = "float32"

    @property
    def growth_rate(self) -> float:
        r_min, r_max = 2**self.min_logres, 2**self.max_logres
        if self.num_levels == 1:
            return 1.0
        return float(np.exp((np.log(r_max) - np.log(r_min)) / (self.num_levels - 1)))

    @property
    def resolutions(self) -> Tuple[int, ...]:
        """Per-level grid resolutions: floor(r_min * g^lv) + 1 (numpy float64,
        as the JAX package computes them)."""
        r_min = 2**self.min_logres
        g = self.growth_rate
        return tuple(int(np.floor(r_min * g**lv)) + 1 for lv in range(self.num_levels))

    @property
    def table_sizes(self) -> Tuple[int, ...]:
        """Entries per level: dense when it fits, else the hash-table size."""
        T = 2**self.log2_hashmap_size
        return tuple(res**3 if res**3 <= T else T for res in self.resolutions)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.table_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_tables(spec: HashGridSpec, generator: torch.Generator, scale: float = 1e-4):
    """Per-level tables [size_l, F], Uniform(-scale, scale) (Instant-NGP
    default), drawn in float32 on the CPU and cast to the table dtype."""
    return [
        ((torch.rand(size, spec.features_per_level, generator=generator) * 2 - 1) * scale)
        .to(spec.torch_dtype)
        for size in spec.table_sizes
    ]


def active_levels_to_mask(active_levels: int, num_levels: int) -> np.ndarray:
    """[L] float32 mask with ones on the first ``active_levels`` levels."""
    return (np.arange(num_levels) < active_levels).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _corners(device: torch.device) -> torch.Tensor:
    """[8,3] int64 corner offsets (dx, dy, dz), corner c = 4*dx + 2*dy + dz,
    made once per device."""
    c = torch.arange(8, device=device)
    return torch.stack([(c >> 2) & 1, (c >> 1) & 1, c & 1], dim=1)


# The corners' (dx, dy, dz) as host ints, in ``_corners``' order.
_CORNER_OFFSETS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


def _cell_frac(x01: torch.Tensor, res: int):
    """Cell (float, clamped to [0, res-2]) and in-cell fraction (clamped to
    [0, 1]) of normalized points [..., 3] at a level of resolution ``res``."""
    p = x01 * (float(res) - 1.0)
    cell = torch.clamp(torch.floor(p), 0.0, float(res) - 2.0)
    return cell, torch.clamp(p - cell, 0.0, 1.0)


def _trilinear(frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights [..., 8, P] of fractions [..., P, 3]; unclamped
    fractions give the linear extrapolation of the cell's patch."""
    corners = _corners(frac.device)
    wx, wy, wz = (torch.where(corners[:, a:a + 1] == 1, frac[..., a][..., None, :], 1.0 - frac[..., a][..., None, :])
                  for a in range(3))
    return wx * wy * wz


def _rows(cell: torch.Tensor, spec: HashGridSpec, lv: int) -> torch.Tensor:
    """[8,P] int32 table rows of the corners of cells [P,3] at level ``lv``."""
    corners = _corners(cell.device)
    icell = cell.to(torch.int64)
    ix, iy, iz = (icell[:, a][None] + corners[:, a:a + 1] for a in range(3))  # [8,P]
    size = spec.table_sizes[lv]
    if spec.resolutions[lv] ** 3 <= size:
        r = spec.resolutions[lv]
        idx = ix + r * (iy + r * iz)
    else:
        # uint32 products, emulated in int64 and wrapped before the XOR.
        idx = (ix * _PRIMES[0]) ^ ((iy * _PRIMES[1]) & _UINT32_MASK) ^ ((iz * _PRIMES[2]) & _UINT32_MASK)
        idx = idx % size
    return idx.to(torch.int32)


def level_corners(x01: torch.Tensor, spec: HashGridSpec, lv: int):
    """Corner rows and trilinear weights of one level.

    x01: [P,3] points normalized to [0,1]. Returns (idx [8,P] int32 row
    indices into the level's table, weights [8,P] float32).
    """
    cell, frac = _cell_frac(x01, spec.resolutions[lv])
    return _rows(cell, spec, lv), _trilinear(frac)


class _Combine(torch.autograd.Function):
    """``out[e,p,:] = sum_c w[c,e,p] * feats[c,p,:]`` (float32; feats
    [8,P,F], w [8,E,P]). The 8 products are summed by elementwise adds in
    one fixed order, ((c0+c4)+(c2+c6))+((c1+c5)+(c3+c7)), so a sum does not
    depend on E or on the feats' layout; the backward is the products'.
    The feats are kept for the backward only where the weights need a
    gradient (they do not in training: that would hold a float32 copy of
    every lookup's corner rows until the backward)."""

    @staticmethod
    def forward(ctx, feats, w):
        ctx.save_for_backward(feats if ctx.needs_input_grad[1] else None, w)
        total = feats[:, None] * w[..., None]  # [8,E,P,F]
        while total.shape[0] > 1:
            half = total.shape[0] // 2
            total = total[:half] + total[half:]
        return total[0]

    @staticmethod
    def backward(ctx, grad):
        feats, w = ctx.saved_tensors
        g_feats = g_w = None
        if ctx.needs_input_grad[0]:
            g_feats = (grad[0] * w[:, 0, :, None] if w.shape[1] == 1
                       else (grad[None] * w[..., None]).sum(dim=1))
        if ctx.needs_input_grad[1]:
            g_w = torch.einsum("cpf,epf->cep", feats, grad)
        return g_feats, g_w


def _combine(feats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_c weights[e,c,p] * feats[c,p,:] -> [E,P,F] in the feats' dtype:
    the weights rounded to that dtype, the sum taken in float32 in a fixed
    order (:class:`_Combine`), rounded once."""
    w = weights.to(feats.dtype).float().transpose(0, 1)  # [8,E,P]
    return _Combine.apply(feats.float(), w).to(feats.dtype)


# ---------------------------------------------------------------------------
# Blocked dense levels
# ---------------------------------------------------------------------------


def blocked_dense_table(table: torch.Tensor, res: int) -> torch.Tensor:
    """Per-cell corner blocks of a dense level's table: [(res-1)^3, 8F],
    row ``cx + (res-1)*(cy + (res-1)*cz)`` holding the cell's 8 corner rows
    in corner order. 8 shifted slices of the grid, stacked; autograd takes
    their backward as dense adds."""
    F = table.shape[-1]
    r, m = int(res), int(res) - 1
    grid = table[: r * r * r].reshape(r, r, r, F)  # axes (z, y, x): row = x + r*(y + r*z)
    blocks = [grid[dz:dz + m, dy:dy + m, dx:dx + m] for dx, dy, dz in _CORNER_OFFSETS]
    return torch.stack(blocks, dim=3).reshape(m * m * m, 8 * F)


def _blocked_take(table: torch.Tensor, res: int, cell: torch.Tensor) -> torch.Tensor:
    """The 8 corner rows [8,P,F] of cells [P,3] through one gathered row of
    the blocked table per point; the same values as the 8-row gather."""
    F = table.shape[-1]
    m = int(res) - 1
    icell = cell.to(torch.int64)
    cid = (icell[:, 0] + m * (icell[:, 1] + m * icell[:, 2])).to(torch.int32)
    rows = take_rows(blocked_dense_table(table, res), cid)  # [P, 8F]
    return rows.reshape(-1, 8, F).permute(1, 0, 2)


# ---------------------------------------------------------------------------
# Corner-sampled table gradient
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CornerSampling:
    """Settings of the corner-sampled table gradient and the source of its
    uniforms: ``draw(stream, shape, device)`` returns float32 uniforms in
    [0, 1). ``stream`` is the integer the JAX package folds into its corner
    key for that lookup (the level; in the stencil's exact levels
    ``level * (1+T+1) + evaluation + 1``), so a caller can hand in JAX's own
    draws; the training path ignores it and draws from its generator."""

    draw: Callable[[int, Tuple[int, int], torch.device], torch.Tensor]
    floor: float = 0.125
    k: int = 1
    mode: str = "cotangent"
    exact_finest: int = 0


def generator_draw(generator: Optional[torch.Generator]):
    """A ``CornerSampling.draw`` that takes every uniform from ``generator``."""

    def draw(stream, shape, device):
        return torch.rand(shape, generator=generator, device=device)

    return draw


class CornerSampledCombine(torch.autograd.Function):
    """``out[e] = sum_c weights[e,c] * table[idx[c]]`` (the exact combine)
    whose table gradient is an unbiased estimate of the exact 8-corner
    scatter that scatters 1 + k (``top1cot``) or k rows per point.

    The exact per-corner cotangent row is ``v[c] = sum_e weights[e,c] *
    ct[e]``. A corner ``c*`` is drawn from ``q`` and ``v[c*] / (q[c*] k)``
    scattered, k times:

      cotangent  q ~ |v[c]|_1 mixed with ``floor`` / 8;
      top1cot    the largest-norm corner is scattered exactly, and k draws
                 from the other 7 by their norms (``floor`` / 7);
      center     q ~ the centre evaluation's trilinear weights, mixed with
                 ``floor`` / 8.

    A uniform u picks the corner whose interval [cdf[i-1], cdf[i]) holds
    u * cdf[-1] (``>=``), so a zero-width interval (top1cot's excluded
    corner) is never picked. The rows go to ``scatter_add_rows``.
    """

    @staticmethod
    def forward(ctx, table, idx, weights, draw, floor, k, mode):
        # table [S,F]; idx [8,P] int32; weights [E,8,P] float32; draw() -> u [k,P]
        P, F = idx.shape[1], table.shape[-1]
        feats = table.index_select(0, idx.reshape(-1)).reshape(8, P, F)
        ctx.save_for_backward(table, idx, weights)
        ctx.draw, ctx.floor, ctx.k, ctx.mode = draw, float(floor), int(k), mode
        return _combine(feats, weights)

    @staticmethod
    def backward(ctx, ct):
        table, idx, weights = ctx.saved_tensors
        floor, k, mode = ctx.floor, ctx.k, ctx.mode
        P, F = idx.shape[1], table.shape[-1]
        ct32 = ct.float()  # [E,P,F]
        g_weights = None
        if ctx.needs_input_grad[2]:
            feats = table.index_select(0, idx.reshape(-1)).reshape(8, P, F).float()
            g_weights = torch.einsum("epf,cpf->ecp", ct32, feats)
        if not ctx.needs_input_grad[0]:
            return None, None, g_weights, None, None, None, None
        corner = torch.arange(8, device=idx.device)[:, None]
        if mode in ("cotangent", "top1cot"):
            v = torch.einsum("ecp,epf->cpf", weights, ct32)  # exact per-corner rows [8,P,F]
            n = v.abs().sum(dim=-1)  # [8,P]
            if mode == "top1cot":
                top = torch.argmax(n, dim=0)  # [P]
                is_max = corner == top[None]
                n_r = torch.where(is_max, 0.0, n)
                s_r = n_r.sum(dim=0, keepdim=True)
                q = torch.where(s_r > 0.0,
                                (1.0 - floor) * n_r / torch.clamp(s_r, min=1e-30)
                                + torch.where(is_max, 0.0, floor / 7.0),
                                torch.where(is_max, 0.0, 1.0 / 7.0))
            else:
                s = n.sum(dim=0, keepdim=True)
                q = torch.where(s > 0.0, (1.0 - floor) * n / torch.clamp(s, min=1e-30) + floor / 8.0,
                                torch.full_like(n, 1.0 / 8.0))
        elif mode == "center":
            w0 = torch.clamp(weights[0], min=0.0)
            s0 = torch.clamp(w0.sum(dim=0, keepdim=True), min=1e-9)
            q = (1.0 - floor) * (w0 / s0) + floor / 8.0
        else:
            raise ValueError(f"corner sampling mode '{mode}'")
        cdf = torch.cumsum(q, dim=0)  # [8,P]
        u = ctx.draw().to(torch.float32) * cdf[-1:]  # [k,P]
        pick = (u[:, None, :] >= cdf[None, :-1, :]).sum(dim=1)  # [k,P] corner
        rows = torch.gather(idx.long(), 0, pick)  # [k,P]
        q_pick = torch.clamp(torch.gather(q, 0, pick), min=1e-9)
        if mode == "center":
            w_pick = torch.gather(weights, 1, pick[None].expand(weights.shape[0], -1, -1))  # [E,k,P]
            vals = torch.einsum("epf,ekp->kpf", ct32, w_pick) / (q_pick * k)[..., None]
        else:
            vals = torch.gather(v, 0, pick[..., None].expand(-1, -1, F)) / (q_pick * k)[..., None]
            if mode == "top1cot":  # the largest corner's exact row first
                rows = torch.cat([torch.gather(idx.long(), 0, top[None]), rows])
                vals = torch.cat([torch.gather(v, 0, top[None, :, None].expand(1, -1, F)), vals])
        vals = vals.to(table.dtype).reshape(-1, F)
        g = hashgrid_scatter.scatter_add_rows(rows.reshape(-1).to(torch.int32), vals, table.shape[0])
        return g.to(table.dtype), None, g_weights, None, None, None, None


def _gather_combine(table, cell, weights, spec: HashGridSpec, lv: int, dense_blocked: bool,
                    corner: Optional[CornerSampling], streams: Sequence[int]) -> torch.Tensor:
    """Features [E,P,F] of cells [P,3] weighted by weights [E,8,P] at level
    ``lv``: through the blocked table on a dense level with
    ``dense_blocked`` (exact, so it supersedes corner sampling there),
    through the corner-sampled combine with ``corner`` (the P points split
    evenly over ``streams``), else through the 8-row gather."""
    global gathers
    gathers += 1
    dense = spec.resolutions[lv] ** 3 <= spec.table_sizes[lv]
    if dense_blocked and dense:
        return _combine(_blocked_take(table, spec.resolutions[lv], cell), weights)
    idx = _rows(cell, spec, lv)
    if corner is not None and lv < spec.num_levels - corner.exact_finest:
        n = idx.shape[1] // len(streams)

        def draw():
            return torch.cat([corner.draw(s, (corner.k, n), idx.device) for s in streams], dim=1)

        return CornerSampledCombine.apply(table, idx, weights, draw, corner.floor, corner.k, corner.mode)
    P, F = idx.shape[1], table.shape[-1]
    return _combine(take_rows(table, idx.reshape(-1)).reshape(8, P, F), weights)


def _normalize(points: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    return (points.reshape(-1, 3).float() - spec.range_min) / (spec.range_max - spec.range_min)


def _masked_concat(outs: List[torch.Tensor], spec: HashGridSpec, level_mask) -> torch.Tensor:
    """Levels [..., P, F] -> [..., P, L*F], masked, zero-padded past the cap."""
    for lv, out in enumerate(outs):
        if level_mask is not None and float(level_mask[lv]) != 1.0:
            outs[lv] = out * float(level_mask[lv])
    missing = spec.num_levels - len(outs)
    if missing:
        outs.append(outs[0].new_zeros(*outs[0].shape[:-1], missing * spec.features_per_level))
    return torch.cat(outs, dim=-1)


def _active_levels(spec: HashGridSpec, max_levels: Optional[int]) -> int:
    return spec.num_levels if max_levels is None else min(int(max_levels), spec.num_levels)


def encode(tables: Sequence[torch.Tensor], points: torch.Tensor, spec: HashGridSpec,
           level_mask: Optional[Sequence[float]] = None, max_levels: Optional[int] = None,
           dense_blocked: bool = False, corner: Optional[CornerSampling] = None):
    """Encode 3D points into concatenated per-level features.

    Args:
        tables: per-level [size_l, F] tables.
        points: [..., 3] points in world units (normalized with
            ``spec.range_min/max``).
        level_mask: optional [L] coarse-to-fine mask (0/1 per level).
        max_levels: optional level cap: levels beyond it are not gathered
            and their features are zero.
        dense_blocked: read dense levels through their blocked tables.
        corner: sample the table gradient's corners (None: exact).
    Returns:
        features [..., L*F] in the tables' dtype.
    """
    x01 = _normalize(points, spec)
    outs = []
    for lv in range(_active_levels(spec, max_levels)):
        cell, frac = _cell_frac(x01, spec.resolutions[lv])
        outs.append(_gather_combine(tables[lv], cell, _trilinear(frac)[None], spec, lv, dense_blocked,
                                    corner, [lv]).squeeze(0))
    return _masked_concat(outs, spec, level_mask).reshape(*points.shape[:-1], spec.output_dim)


def encode_stencil(tables: Sequence[torch.Tensor], points: torch.Tensor, offsets: torch.Tensor,
                   spec: HashGridSpec, level_mask: Optional[Sequence[float]] = None, shared_levels: int = 0,
                   max_levels: Optional[int] = None, dense_blocked: bool = False,
                   corner: Optional[CornerSampling] = None):
    """Encode a point and its T taps (``points[..., None, :] + offsets``)
    together.

    Levels below ``shared_levels`` gather the centre's cell corners once;
    each of the 1+T evaluations combines them with its own trilinear
    weights from its cell-relative position, unclamped: bitwise ``encode``
    for a tap inside the centre's cell, the linear extrapolation of the
    cell's patch for one outside it. The other levels take each
    evaluation's own cell, as ``encode`` does, in one gather for all 1+T.
    Tap coordinates are normalized as ``x01 + offsets / extent``.

    Args:
        offsets: [T, 3] tap offsets in world units.
        shared_levels: number of coarse levels on the shared path.
        (the rest as ``encode``)
    Returns:
        features [..., 1+T, L*F]; index 0 is the centre.
    """
    x01 = _normalize(points, spec)
    P = x01.shape[0]
    off01 = offsets.to(device=x01.device, dtype=torch.float32) / (spec.range_max - spec.range_min)
    offs = torch.cat([off01.new_zeros(1, 3), off01])  # [E,3], the centre first
    E = offs.shape[0]
    active = _active_levels(spec, max_levels)
    outs = []
    for lv in range(active):
        res = spec.resolutions[lv]
        if lv < min(int(shared_levels), active):
            cell, frac = _cell_frac(x01, res)
            weights = _trilinear(frac[None] + offs[:, None, :] * (float(res) - 1.0))  # [E,8,P]
            outs.append(_gather_combine(tables[lv], cell, weights, spec, lv, dense_blocked, corner, [lv]))
        else:
            cell, frac = _cell_frac((x01[None] + offs[:, None, :]).reshape(E * P, 3), res)
            streams = [lv * (E + 1) + e + 1 for e in range(E)]
            out = _gather_combine(tables[lv], cell, _trilinear(frac)[None], spec, lv, dense_blocked, corner,
                                  streams)
            outs.append(out.reshape(E, P, -1))
    out = _masked_concat(outs, spec, level_mask)  # [E,P,L*F]
    return out.permute(1, 0, 2).reshape(*points.shape[:-1], E, spec.output_dim)
