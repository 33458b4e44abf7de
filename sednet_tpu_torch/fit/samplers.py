"""Parametric surface samplers for fitted primitives (visualization, residual
upsampling, meshing). Numpy, host-side — these feed the OBJ writer and the
trim logic, not the training path.

Rebuild of reference Fit.sample_* (src/primitive_forward.py:431-697):
regular parameter grids, optional trimming of cone/cylinder by the axial
extent of the segment's input points. A copy of
`sednet_tpu/fit/samplers.py`.
"""
from __future__ import annotations

import numpy as np

from sednet_tpu_torch.data.geometry import rotation_matrix_a_to_b

EPS = 1e-8


def _grid(nu: int, nv: int) -> np.ndarray:
    u, v = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
    return np.stack([u.ravel(), v.ravel()], 1)


def sample_plane(d: float, n: np.ndarray, mean: np.ndarray,
                 nu: int = 120, nv: int = 120) -> np.ndarray:
    """Grid on the plane {x: n.x = d}, centered at `mean`'s projection
    (reference: src/primitive_forward.py:456-476)."""
    n = np.asarray(n, float).reshape(3)
    n = n / (np.linalg.norm(n) + EPS)
    h = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0.0, 1, 0])
    x = np.cross(n, h)
    x /= np.linalg.norm(x) + EPS
    y = np.cross(n, x)
    param = (1 - 2 * _grid(nu, nv)) * 0.75
    center = mean + (d - np.dot(n, mean)) * n  # project mean onto the plane
    return center + param[:, :1] * x + param[:, 1:] * y


def sample_sphere(radius: float, center: np.ndarray, n: int = 1000) -> np.ndarray:
    """Uniform-ish sphere sampling (reference: src/primitive_forward.py:605-621)."""
    rng = np.random.RandomState(0)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + EPS
    return center.reshape(1, 3) + radius * d


def sample_cylinder(radius: float, center: np.ndarray, axis: np.ndarray,
                    height: float = 1.0, n_theta: int = 60,
                    n_z: int = 30) -> np.ndarray:
    """Lateral cylinder surface grid (reference: src/primitive_forward.py:669-697)."""
    axis = np.asarray(axis, float).reshape(3)
    axis /= np.linalg.norm(axis) + EPS
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    z = np.linspace(-height / 2, height / 2, n_z)
    tt, zz = np.meshgrid(theta, z)
    circle = np.stack([np.cos(tt.ravel()), np.sin(tt.ravel()),
                       zz.ravel() / max(radius, EPS)], 1) * radius
    r = rotation_matrix_a_to_b(np.array([0.0, 0, 1.0]), axis)
    return (r @ circle.T).T + center.reshape(1, 3)


def sample_cylinder_trim(radius, center, axis, points, n_theta=60, n_z=30):
    """Trim to the axial extent of the segment points
    (reference: src/primitive_forward.py:623-667)."""
    axis = np.asarray(axis, float).reshape(3)
    axis /= np.linalg.norm(axis) + EPS
    proj = (points - center.reshape(1, 3)) @ axis
    lo, hi = float(proj.min()), float(proj.max())
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    z = np.linspace(lo, hi, n_z)
    tt, zz = np.meshgrid(theta, z)
    r = rotation_matrix_a_to_b(np.array([0.0, 0, 1.0]), axis)
    pts = np.stack([radius * np.cos(tt.ravel()), radius * np.sin(tt.ravel()),
                    zz.ravel()], 1)
    return (r @ pts.T).T + center.reshape(1, 3)


def sample_cone(apex: np.ndarray, axis: np.ndarray, theta: float,
                height: float = 1.0, n_phi: int = 60,
                n_t: int = 30) -> np.ndarray:
    """Cone surface grid from apex along axis
    (reference: src/primitive_forward.py:546-591)."""
    axis = np.asarray(axis, float).reshape(3)
    axis /= np.linalg.norm(axis) + EPS
    phi = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t = np.linspace(0.01, height, n_t)
    pp, tt = np.meshgrid(phi, t)
    local = np.stack([tt.ravel() * np.tan(theta) * np.cos(pp.ravel()),
                      tt.ravel() * np.tan(theta) * np.sin(pp.ravel()),
                      tt.ravel()], 1)
    r = rotation_matrix_a_to_b(np.array([0.0, 0, 1.0]), axis)
    return (r @ local.T).T + apex.reshape(1, 3)


def sample_cone_trim(apex, axis, theta, points, n_phi=60, n_t=30):
    """Trim by the axial extent of the segment points
    (reference: src/primitive_forward.py:478-544)."""
    axis = np.asarray(axis, float).reshape(3)
    axis /= np.linalg.norm(axis) + EPS
    proj = (points - apex.reshape(1, 3)) @ axis
    lo, hi = max(float(proj.min()), 0.01), max(float(proj.max()), 0.02)
    return sample_cone(apex, axis, theta, height=hi, n_phi=n_phi, n_t=n_t)


def sample_torus(r_major: float, r_minor: float, center: np.ndarray,
                 axis: np.ndarray, n_u: int = 100, n_v: int = 60) -> np.ndarray:
    """Reference: src/primitive_forward.py:431-454."""
    axis = np.asarray(axis, float).reshape(3)
    axis /= np.linalg.norm(axis) + EPS
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v)
    x = (r_major + r_minor * np.cos(vv)) * np.cos(uu)
    y = (r_major + r_minor * np.cos(vv)) * np.sin(uu)
    z = r_minor * np.sin(vv)
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    r = rotation_matrix_a_to_b(np.array([0.0, 0, 1.0]), axis)
    return (r @ pts.T).T + center.reshape(1, 3)
