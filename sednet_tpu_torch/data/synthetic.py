"""Synthetic CAD-like shapes assembled from analytic primitives.

A numpy copy of `sednet_tpu/data/synthetic.py` (samplers and
`make_synthetic_shape`): the same draws from the same
`np.random.RandomState` in the same order, so that one seed gives both
packages the same shapes. Type ids follow the reference vocabulary
(src/segment_utils.py:156-164): 1 plane, 3 cone, 4 cylinder, 5 sphere.
"""
from __future__ import annotations

import numpy as np

# Generator stream reserved for evaluation fixtures (synthetic.py:153).
EVAL_STREAM_SEED = 90210


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _orthobasis(rng, axis=None):
    a = _unit(rng.randn(3)) if axis is None else _unit(np.asarray(axis, float))
    h = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = _unit(np.cross(a, h))
    v = np.cross(a, u)
    return a, u, v


def sample_plane(rng, n, scale=0.5):
    a, u, v = _orthobasis(rng)
    origin = rng.randn(3) * 0.3
    s = rng.uniform(-scale, scale, (n, 2))
    pts = origin + s[:, :1] * u + s[:, 1:] * v
    nrm = np.tile(a, (n, 1))
    params = {"type": "plane", "normal": a, "distance": float(np.dot(a, origin))}
    return pts, nrm, params


def sample_sphere(rng, n, radius=None):
    center = rng.randn(3) * 0.3
    r = radius or rng.uniform(0.2, 0.6)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = center + r * d
    params = {"type": "sphere", "center": center, "radius": float(r)}
    return pts, d.copy(), params


def sample_cylinder(rng, n, radius=None, height=None):
    a, u, v = _orthobasis(rng)
    center = rng.randn(3) * 0.3
    r = radius or rng.uniform(0.15, 0.5)
    h = height or rng.uniform(0.4, 1.0)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-h / 2, h / 2, n)
    radial = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * v
    pts = center + r * radial + z[:, None] * a
    params = {"type": "cylinder", "axis": a, "center": center, "radius": float(r),
              "height": float(h)}
    return pts, radial, params


def sample_cone(rng, n, half_angle=None, height=None):
    a, u, v = _orthobasis(rng)
    apex = rng.randn(3) * 0.3
    theta = half_angle or rng.uniform(0.2, 0.9)
    h = height or rng.uniform(0.4, 1.0)
    t = np.sqrt(rng.uniform(0.05, 1.0, n)) * h
    phi = rng.uniform(0, 2 * np.pi, n)
    radial = np.cos(phi)[:, None] * u + np.sin(phi)[:, None] * v
    pts = apex + t[:, None] * a + (t * np.tan(theta))[:, None] * radial
    nrm = np.cos(theta) * radial - np.sin(theta) * a
    params = {"type": "cone", "apex": apex, "axis": a, "theta": float(theta),
              "height": float(h)}
    return pts, nrm, params


_SAMPLERS = {1: sample_plane, 3: sample_cone, 4: sample_cylinder, 5: sample_sphere}


def make_synthetic_shape(rng, n_points: int = 10000, n_segments: int | None = None,
                         edge_radius: float = 0.03):
    """One multi-primitive shape: a dict with points/normals/labels/prim/
    edges/edges_w (all (N, ...)) and the list of primitive parameters."""
    k = n_segments or rng.randint(3, 8)
    types = rng.choice(list(_SAMPLERS), size=k)
    counts = np.full(k, n_points // k)
    counts[: n_points - counts.sum()] += 1

    pts, nrm, labels, prim, params = [], [], [], [], []
    for i, (t, c) in enumerate(zip(types, counts)):
        p, nr, par = _SAMPLERS[int(t)](rng, int(c))
        pts.append(p)
        nrm.append(nr)
        labels.append(np.full(c, i, np.int32))
        prim.append(np.full(c, t, np.int32))
        params.append(par)
    points = np.concatenate(pts).astype(np.float32)
    normals = np.concatenate(nrm).astype(np.float32)
    labels = np.concatenate(labels)
    prim = np.concatenate(prim)

    # boundary edges: points whose nearest other-instance point is close.
    # The expanded-square form only picks the argmin; that one distance is
    # then recomputed exactly, as in the reference generator.
    min_other = np.full(n_points, np.inf, np.float32)
    for i in range(k):
        own = np.nonzero(labels == i)[0]
        other = points[labels != i][::3].astype(np.float32)
        if own.size == 0 or other.shape[0] == 0:
            continue
        osq = (other ** 2).sum(1)
        for c0 in range(0, own.size, 4096):
            a = points[own[c0:c0 + 4096]]
            d2 = ((a ** 2).sum(1)[:, None] + osq[None, :]
                  - 2.0 * (a @ other.T))
            j = d2.argmin(1)
            min_other[own[c0:c0 + 4096]] = np.sqrt(
                ((a - other[j]) ** 2).sum(1))
    thresh = max(edge_radius, float(np.percentile(min_other, 8)))
    edges = (min_other < thresh).astype(np.int32)
    edges_w = np.ones(n_points, np.float32)

    return {
        "points": points,
        "normals": normals,
        "labels": labels,
        "prim": prim,
        "edges": edges,
        "edges_w": edges_w,
        "params": params,
    }
