"""Weighted least-squares primitive fits.

Counterpart of `sednet_tpu/fit/primitives.py:31-175` (reference:
src/primitive_forward.py:712-847). Every fit takes points (..., P, 3) with
per-point weights (..., P), so one call fits a whole (S, P) batch of
segments padded with zero weight and zero points: each fit touches the
points only through weight-multiplied terms, so the padding leaves it
unchanged. JAX vmaps a per-segment function and pads the point count to a
few buckets (`_fit_bucket`) so that XLA compiles once a bucket; PyTorch
compiles nothing, so the port pads to the batch's largest segment.

As in JAX, the ridge normal equations replace the reference's QR-or-ridge
choice, and the smallest right singular vector comes from a batched SVD
(LAPACK on the CPU, cuSOLVER on the card). Its sign is the solver's: the
plane's (n, d) and the cylinder's axis may come out negated, which no
distance sees; the cone's axis is flipped to point inside.
"""
from __future__ import annotations

import torch

from sednet_tpu_torch.ops.guard import guard_sqrt

EPS = 1e-8


def _dot3(points, v):
    """points (..., P, 3) . v (..., 3) -> (..., P)."""
    return (points @ v.unsqueeze(-1)).squeeze(-1)


def ridge_lstsq(a, y, lamb: float = 0.01):
    """Solve min ||A x - y||^2 + lamb ||x||^2 for A (..., P, k), y (..., P, m)
    (reference ridge branch: src/fitting_utils.py:63-82)."""
    at = a.transpose(-1, -2)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.linalg.solve(at @ a + lamb * eye, at @ y)


def _smallest_right_singular(m):
    """Right singular vector of m (..., P, 3) for its smallest singular
    value."""
    return torch.linalg.svd(m, full_matrices=False)[2][..., -1, :]


def fit_plane(points, weights):
    """Weighted plane {x : n.x = d} (reference: primitive_forward.py:712-733).
    Returns (normal (..., 3), d (...))."""
    w = weights.unsqueeze(-1)
    wsum = w.sum((-2, -1)) + EPS
    centroid = (w * points).sum(-2) / wsum.unsqueeze(-1)
    a = _smallest_right_singular(w * (points - centroid.unsqueeze(-2)))
    d = (weights * _dot3(points, a)).sum(-1) / wsum
    return a, d


def fit_sphere(points, weights):
    """Weighted sphere by linear least squares on the centre
    (reference: primitive_forward.py:750-773). Returns (centre (..., 3),
    radius (...))."""
    w = weights.unsqueeze(-1)
    wsum = (w.sum((-2, -1)) + EPS)[..., None, None]
    a = 2.0 * (-points + (points * w).sum(-2, keepdim=True) / wsum)
    dot = w * (points * points).sum(-1, keepdim=True)
    y = dot - dot.sum(-2, keepdim=True) / wsum
    center = -ridge_lstsq(w * a, w * y, 0.01)[..., 0]
    r2 = (weights * ((points - center.unsqueeze(-2)) ** 2).sum(-1)).sum(-1) \
        / wsum[..., 0, 0]
    return center, guard_sqrt(torch.clamp(r2, min=1e-3))


def fit_cylinder(points, normals, weights):
    """Axis from the normals' null space; centre and radius by the sphere
    fit of the points projected on the plane across it
    (reference: primitive_forward.py:788-810). Returns (axis, centre,
    radius)."""
    a = _smallest_right_singular(weights.unsqueeze(-1) * normals)
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + EPS)
    prj = points - _dot3(points, a).unsqueeze(-1) * a.unsqueeze(-2)
    center, radius = fit_sphere(prj, weights)
    return a, center, radius


def fit_cone(points, normals, weights):
    """Apex from n.x = n.p by least squares, axis the plane fit of the
    normals flipped to point inside, half-angle the weighted mean angle
    (reference: primitive_forward.py:812-847). Returns (apex, axis,
    theta)."""
    w = weights.unsqueeze(-1)
    y = w * (normals * points).sum(-1, keepdim=True)
    apex = ridge_lstsq(w * normals, y, 1e-3)[..., 0]

    axis, _ = fit_plane(normals, weights)
    flip = _dot3(normals, axis).sum(-1, keepdim=True) > 0
    axis = torch.where(flip, -axis, axis)

    diff = points - apex.unsqueeze(-2)
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    diff = diff / torch.clamp(norm, min=1e-12)
    cos = torch.clamp(_dot3(diff, axis).abs(), max=0.999)
    theta = (weights * torch.arccos(cos)).sum(-1) / (weights.sum(-1) + EPS)
    return apex, axis, torch.clamp(theta, 1e-3, 3.142 / 2 - 1e-3)


def fit_all_types_batched(points, normals, weights) -> dict:
    """All four fits of a padded batch of segments, points/normals (S, P, 3)
    and weights (S, P) with zero weight and zero points on the padding.
    Returns {"plane": (n, d), "sphere": (c, r), "cylinder": (a, c, r),
    "cone": (apex, axis, theta)}, each entry stacked over S."""
    return {"plane": fit_plane(points, weights),
            "sphere": fit_sphere(points, weights),
            "cylinder": fit_cylinder(points, normals, weights),
            "cone": fit_cone(points, normals, weights)}


def fit_all_types_packed(points, normals, weights):
    """`fit_all_types_batched` packed into one (S, 22) tensor, so that one
    device-to-host copy fetches every fit. Layout: plane n[0:3] d[3] |
    sphere c[4:7] r[7] | cylinder a[8:11] c[11:14] r[14] | cone apex[15:18]
    axis[18:21] theta[21]."""
    out = fit_all_types_batched(points, normals, weights)
    pn, pd = out["plane"]
    sc, sr = out["sphere"]
    ca, cc, cr = out["cylinder"]
    ka, kx, kt = out["cone"]
    return torch.cat([pn, pd[:, None], sc, sr[:, None], ca, cc, cr[:, None],
                      ka, kx, kt[:, None]], dim=1)


def unpack_fit_params(row, name: str):
    """One row of `fit_all_types_packed` (numpy, on the host) -> the
    parameter tail of `name`."""
    if name == "plane":
        return [row[0:3], row[3]]
    if name == "sphere":
        return [row[4:7], row[7]]
    if name == "cylinder":
        return [row[8:11], row[11:14], row[14]]
    if name == "cone":
        return [row[15:18], row[18:21], row[21]]
    raise KeyError(name)
