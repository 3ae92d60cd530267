"""Isosurface extraction on the host: marching tetrahedra in the port's
own C++ library (``csrc/marching_tets.cpp``, built with g++ into
``build/`` and bound with ctypes), vertex welding and PLY export.

``_marching_tets_numpy`` is the plain version of the same decomposition,
for the tests only: a missing compiler or a failed build raises, it does
not fall back to numpy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from mlinerf_tpu_torch.ops import cuda_build

_LIB = None


def _get_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("marching_tets")
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        _LIB = lib
    return _LIB


def marching_tets(field: np.ndarray, iso: float = 0.0) -> np.ndarray:
    """The iso-surface of a [nx,ny,nz] scalar field as a triangle soup
    [T, 3, 3] in grid-index coordinates."""
    field = np.ascontiguousarray(field, np.float32)
    if field.ndim != 3:
        raise ValueError(f"marching_tets: field must be 3-D, got shape {field.shape}")
    nx, ny, nz = field.shape
    lib = _get_lib()
    # Start at a bounded buffer and grow it on overflow.
    cap = min(int(3 * 12 * max(nx * ny * nz, 1)), 4_000_000 * 3)
    while True:
        out = np.empty((cap, 3), np.float32)
        n = ctypes.c_long(0)
        ret = lib.marching_tets(
            field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
            ctypes.c_float(iso), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_long(cap), ctypes.byref(n),
        )
        if ret == 0:
            return out[: n.value].reshape(-1, 3, 3)
        cap *= 4


# ---------------------------------------------------------------------------
# The plain version (vectorized over cubes; the same tet decomposition).
# ---------------------------------------------------------------------------

_TETS = np.asarray(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]]
)
_DX = np.asarray([0, 1, 1, 0, 0, 1, 1, 0])
_DY = np.asarray([0, 0, 1, 1, 0, 0, 1, 1])
_DZ = np.asarray([0, 0, 0, 0, 1, 1, 1, 1])


def _marching_tets_numpy(field: np.ndarray, iso: float) -> np.ndarray:
    nx, ny, nz = field.shape
    xi, yi, zi = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij")
    xi, yi, zi = xi.ravel(), yi.ravel(), zi.ravel()
    vals = np.stack([field[xi + _DX[c], yi + _DY[c], zi + _DZ[c]] for c in range(8)], axis=1)  # [C,8]
    active = ~(np.all(vals < iso, axis=1) | np.all(vals >= iso, axis=1))
    xi, yi, zi, vals = xi[active], yi[active], zi[active], vals[active]
    corners = np.stack(
        [np.stack([xi + _DX[c], yi + _DY[c], zi + _DZ[c]], axis=-1) for c in range(8)], axis=1
    ).astype(np.float32)  # [C,8,3]
    tris = [t for t in (_march_tets_batch(corners[:, tet], vals[:, tet], iso) for tet in _TETS) if len(t)]
    return np.concatenate(tris, axis=0) if tris else np.zeros((0, 3, 3), np.float32)


def _interp(iso, p1, p2, v1, v2):
    denom = v2 - v1
    t = np.where(np.abs(denom) > 1e-12, (iso - v1) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.5)
    t = np.clip(t, 0, 1)[..., None]
    return p1 + t * (p2 - p1)


def _march_tets_batch(p, v, iso):
    """One tet per cube over a batch: p [C,4,3], v [C,4]."""
    inside = v < iso  # [C,4]
    code = inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
    tris = []
    # One corner inside (or outside): a triangle around it.
    one_corner = {1: 0, 2: 1, 4: 2, 8: 3, 14: 0, 13: 1, 11: 2, 7: 3}
    for c_val, a in one_corner.items():
        m = code == c_val
        if not m.any():
            continue
        others = [i for i in range(4) if i != a]
        e = [_interp(iso, p[m, a], p[m, o], v[m, a], v[m, o]) for o in others]
        tris.append(np.stack([e[0], e[1], e[2]], axis=1))
    # Two corners inside: a quad, as two triangles.
    two_corner = {3: (0, 1), 12: (2, 3), 5: (0, 2), 10: (1, 3), 6: (1, 2), 9: (0, 3)}
    for c_val, (a, b) in two_corner.items():
        m = code == c_val
        if not m.any():
            continue
        others = [i for i in range(4) if i not in (a, b)]
        ea0 = _interp(iso, p[m, a], p[m, others[0]], v[m, a], v[m, others[0]])
        ea1 = _interp(iso, p[m, a], p[m, others[1]], v[m, a], v[m, others[1]])
        eb0 = _interp(iso, p[m, b], p[m, others[0]], v[m, b], v[m, others[0]])
        eb1 = _interp(iso, p[m, b], p[m, others[1]], v[m, b], v[m, others[1]])
        tris.append(np.stack([ea0, ea1, eb1], axis=1))
        tris.append(np.stack([ea0, eb1, eb0], axis=1))
    return np.concatenate(tris, axis=0) if tris else np.zeros((0, 3, 3), np.float32)


# ---------------------------------------------------------------------------
# Mesh utilities
# ---------------------------------------------------------------------------


def weld_vertices(tri_soup: np.ndarray, decimals: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle soup [T,3,3] -> (vertices [V,3] float32, faces [T,3] int64):
    vertices equal after rounding to ``decimals`` merge, each keeping its
    first occurrence's exact coordinates."""
    flat = tri_soup.reshape(-1, 3)
    _, first, inverse = np.unique(np.round(flat, decimals), axis=0, return_index=True, return_inverse=True)
    return flat[first].astype(np.float32), inverse.reshape(-1, 3).astype(np.int64)


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None):
    """Write an ASCII PLY (universally readable), with uchar vertex colours
    when ``colors`` [V,3] is given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if len(verts):
            if colors is None:
                np.savetxt(f, np.asarray(verts), fmt="%.6f %.6f %.6f")
            else:
                rows = np.concatenate([np.asarray(verts, np.float64), np.asarray(colors, np.float64)], axis=1)
                np.savetxt(f, rows, fmt="%.6f %.6f %.6f %d %d %d")
        if len(faces):
            np.savetxt(f, np.asarray(faces), fmt="3 %d %d %d")
