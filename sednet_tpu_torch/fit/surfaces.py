"""Surface parameterization and bit-mapped grid trimming.

Rebuild of reference src/curve_utils.py DrawSurfs parameterizations
(:201-221), src/fitting_utils.py create_grid bit mapping (:240-272) and
tessalate_points_fast masked tessellation (:277-303, open3d-free), and
src/bezier.py Bernstein-basis surface evaluation. A copy of
`sednet_tpu/fit/surfaces.py`.
"""
from __future__ import annotations

import math

import numpy as np


def regular_parameterization(grid_u: int, grid_v: int) -> np.ndarray:
    """(grid_u*grid_v, 2) uniform uv grid (reference: curve_utils.py:201-209)."""
    x = np.linspace(0, 1, grid_u)
    y = np.linspace(0, 1, grid_v)
    xv, yv = np.meshgrid(x, y)
    return np.stack([xv.T.ravel(), yv.T.ravel()], 1)


def boundary_parameterization(grid_u: int) -> np.ndarray:
    """uv parameters tracing the unit-square boundary
    (reference: curve_utils.py:211-221)."""
    u = np.arange(grid_u)
    parts = [
        np.stack([np.zeros(grid_u), u], 1),
        np.stack([np.arange(1, grid_u), np.zeros(grid_u - 1)], 1),
        np.stack([np.arange(1, grid_u), np.full(grid_u - 1, grid_u - 1)], 1),
        np.stack([np.full(grid_u - 2, grid_u - 1), np.arange(1, grid_u - 1)], 1),
    ]
    return np.concatenate(parts, 0) / (grid_u - 1)


def grid_bit_mask(input_points: np.ndarray, grid_points: np.ndarray,
                  size_u: int, size_v: int, thresh: float = 0.02) -> np.ndarray:
    """Keep grid cells whose center is within `thresh` of the input cloud
    (reference: fitting_utils.py:240-272). Returns (size_u-1, size_v-1)
    bool."""
    grid = grid_points.reshape(size_u, size_v, 3)
    centers = 0.25 * (grid[:-1, :-1] + grid[1:, :-1] + grid[:-1, 1:]
                      + grid[1:, 1:]).reshape(-1, 3)
    d2 = ((centers[:, None, :] - input_points[None, :, :]) ** 2).sum(-1)
    return (np.sqrt(d2.min(1)) < thresh).reshape(size_u - 1, size_v - 1)


def tessellate_points_fast(points: np.ndarray, size_u: int, size_v: int,
                           mask: np.ndarray | None = None):
    """Masked grid tessellation -> (vertices, 1-indexed triangles), unused
    vertices removed (reference: fitting_utils.py:277-303)."""
    tris = []
    for i in range(size_u - 1):
        for j in range(size_v - 1):
            if mask is not None and not mask[i, j]:
                continue
            a = i * size_v + j
            b = (i + 1) * size_v + j
            tris.append([a, b, b + 1])
            tris.append([a, b + 1, a + 1])
    tris = np.asarray(tris, np.int64) if tris else np.zeros((0, 3), np.int64)
    used = np.unique(tris) if tris.size else np.zeros(0, np.int64)
    remap = -np.ones(points.shape[0], np.int64)
    remap[used] = np.arange(used.shape[0])
    verts = points[used] if used.size else np.zeros((0, 3))
    tris = remap[tris] + 1 if tris.size else tris
    return verts, tris.tolist()


# per-type trim epsilon table (reference: fitting_utils.py:713-820
# visualize_bit_mapping_shape)
TRIM_EPSILON = {
    "plane": 0.02,
    "sphere": 0.03,
    "cylinder": 0.03,
    "cone": 0.03,
    "open-spline": 0.02,
    "closed-spline": 0.02,
}


def trimmed_surface_mesh(input_points: np.ndarray, surface_grid: np.ndarray,
                         size_u: int, size_v: int,
                         kind: str = "plane"):
    """Sampled parametric surface trimmed to cells near the segment's points
    (the reference's visualize_bit_mapping_shape per-primitive path)."""
    eps = TRIM_EPSILON.get(kind, 0.02)
    mask = grid_bit_mask(input_points, surface_grid, size_u, size_v, eps)
    return tessellate_points_fast(surface_grid, size_u, size_v, mask)


def bernstein_basis(n: int, t: np.ndarray) -> np.ndarray:
    """(len(t), n+1) Bernstein polynomials (reference: src/bezier.py)."""
    t = np.asarray(t, float)[:, None]
    k = np.arange(n + 1)[None, :]
    binom = np.array([math.comb(n, int(i)) for i in range(n + 1)])[None, :]
    return binom * t ** k * (1 - t) ** (n - k)


def bezier_surface(control: np.ndarray, grid_u: int = 20,
                   grid_v: int = 20) -> np.ndarray:
    """Evaluate a Bezier patch from an (m+1, n+1, 3) control grid
    (reference: src/bezier.py Bernstein surface demo)."""
    m, n = control.shape[0] - 1, control.shape[1] - 1
    bu = bernstein_basis(m, np.linspace(0, 1, grid_u))
    bv = bernstein_basis(n, np.linspace(0, 1, grid_v))
    return np.einsum("ui,ijc,vj->uvc", bu, control, bv).reshape(-1, 3)
