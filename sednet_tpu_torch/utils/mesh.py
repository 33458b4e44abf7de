"""Mesh and layout helpers for the spline dumps.

Counterpart of `sednet_tpu/utils/mesh.py` (reference src/VisUtils.py):
`tessellate_points` (:163-175) turns a regular UV grid of points into a
triangle mesh; `grid_pointclouds` lays clouds out side by side for one
combined dump. numpy only: the meshes are written as OBJ files.
"""
from __future__ import annotations

import numpy as np


def tessellate_points(points: np.ndarray, size_u: int, size_v: int,
                      viz: bool = False):
    """(size_u*size_v, 3) grid points -> (vertices, triangle faces,
    1-indexed) (reference: src/VisUtils.py:163-175)."""
    del viz
    verts = np.asarray(points).reshape(size_u * size_v, 3)
    faces = []
    for i in range(size_u - 1):
        for j in range(size_v - 1):
            a = i * size_v + j + 1
            b = (i + 1) * size_v + j + 1
            faces.append([a, b, b + 1])
            faces.append([a, b + 1, a + 1])
    return verts, faces


def grid_pointclouds(clouds, cols: int = 5, spacing: float = 1.5):
    """The clouds' xyz, each centred and moved to its cell of a grid of
    `cols` columns, `spacing` apart, in one (sum N, 3) array."""
    out = []
    for i, c in enumerate(clouds):
        c = np.asarray(c)[:, :3]
        c = c - c.mean(0, keepdims=True)
        offset = np.array([(i % cols) * spacing, -(i // cols) * spacing, 0.0])
        out.append(c + offset)
    return np.concatenate(out, 0) if out else np.zeros((0, 3))
