"""Canonical-alignment geometry (copy of `sednet_tpu/data/geometry.py`).

Reference: src/dataset_segments.py:400-415 (max-extent normalisation and
PCA alignment of the smallest eigenvector onto +x) and :481-503.
"""
from __future__ import annotations

import numpy as np

EPS = np.finfo(np.float32).eps


def normalize_points(points: np.ndarray) -> np.ndarray:
    """Mean-centre and scale by the largest axis extent."""
    points = points - points.mean(0, keepdims=True)
    extent = points.max(0) - points.min(0)
    return points / (extent.max() + EPS)


def rotation_matrix_a_to_b(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation R with b = R @ a for unit 3-vectors."""
    cos = float(np.dot(a, b))
    sin = float(np.linalg.norm(np.cross(b, a)))
    u = a
    v = b - np.dot(a, b) * a
    v = v / (np.linalg.norm(v) + EPS)
    w = np.cross(b, a)
    w = w / (np.linalg.norm(w) + EPS)
    f = np.stack([u, v, w], 1)
    g = np.array([[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]])
    try:
        return f @ g @ np.linalg.inv(f)
    except np.linalg.LinAlgError:
        return np.eye(3, dtype=np.float32)


def pca_align(points: np.ndarray, normals: np.ndarray | None = None):
    """Rotate so the smallest principal axis maps to +x.

    Returns (points, normals, R)."""
    s, u = np.linalg.eig(points.T @ points)
    smallest = np.real(u[:, np.argmin(np.real(s))])
    r = rotation_matrix_a_to_b(smallest, np.array([1.0, 0.0, 0.0]))
    points = points @ r.T
    if normals is not None:
        normals = normals @ r.T
    return points, normals, r
