"""B-spline basis, control-grid sampling, standardisation and the
Kronecker least-squares control-point fit.

Counterpart of `sednet_tpu/fit/bspline.py:30-153` (reference:
src/loss.py:190-297, src/fitting_utils.py:493-622, src/approximation.py).
The basis matrices are numpy, built once on the host.

`standardize_points` takes the 3x3 covariance's eigenvectors from
`scipy.linalg.eigh(driver="evd")` in float32 on the host, on the CPU and
on the card alike: a deliberate host step, not a fallback. An
eigenvector's sign is the solver's choice, and the sign of the smallest
one picks the rotation that SplineNet sees. scipy's LAPACK `ssyevd` is the
routine and the build that JAX-CPU's `jnp.linalg.eigh` calls, and gives
its sign; `torch.linalg.eigh` gave the other sign on some thin clouds,
`numpy.linalg.eigh` (another LAPACK build) on some resampled patches, and
cuSOLVER would be a fourth solver. The copy is 36 bytes a spline segment,
which already goes one at a time from the host.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


def basis_function_one(degree: int, knots, span: int, u: float) -> float:
    """Cox-de Boor single basis value (NURBS Book Alg 2.4;
    reference: src/loss.py:242-297)."""
    if ((span == 0 and u == knots[0]) or
            (span == len(knots) - degree - 2 and u == knots[-1])):
        return 1.0
    if u < knots[span] or u >= knots[span + degree + 1]:
        return 0.0
    n = [0.0] * (degree + span + 1)
    for j in range(degree + 1):
        if knots[span + j] <= u < knots[span + j + 1]:
            n[j] = 1.0
    for k in range(1, degree + 1):
        saved = 0.0
        if n[0] != 0.0:
            saved = ((u - knots[span]) * n[0]) / (knots[span + k] - knots[span])
        for j in range(degree - k + 1):
            u_left = knots[span + j + 1]
            u_right = knots[span + j + k + 1]
            if n[j + 1] == 0.0:
                n[j] = saved
                saved = 0.0
            else:
                temp = n[j + 1] / (u_right - u_left)
                n[j] = saved + (u_right - u) * temp
                saved = (u - u_left) * temp
    return n[0]


def uniform_knot_bspline(cu: int, cv: int, du: int, dv: int,
                         grid_size: int = 30):
    """Uniform-knot basis matrices (nu (grid, cu), nv (grid, cv)), float32
    numpy (reference: src/loss.py:190-211)."""
    u = np.arange(0.0, 1.0, 1.0 / grid_size)
    knots_u = ([0.0] * du
               + np.arange(0, 1.01, 1.0 / (cu - du)).tolist() + [1.0] * du)
    knots_v = ([0.0] * dv
               + np.arange(0, 1.01, 1.0 / (cv - dv)).tolist() + [1.0] * dv)
    nu = np.zeros((u.shape[0], cu))
    nv = np.zeros((u.shape[0], cv))
    for i, ui in enumerate(u):
        for j in range(cu):
            nu[i, j] = basis_function_one(du, knots_u, j, ui)
        for j in range(cv):
            nv[i, j] = basis_function_one(dv, knots_v, j, ui)
    return nu.astype(np.float32), nv.astype(np.float32)


def sample_from_control_grid(nu, nv, control, cu: int, cv: int):
    """(B, cu*cv, 3) control grid -> (B, grid^2, 3) surface samples, nu and
    nv tensors on control's device (reference:
    src/fitting_utils.py:609-622)."""
    b = control.shape[0]
    grid = control.reshape(b, cu, cv, 3)
    pts = torch.einsum("gu,buvc,hv->bghc", nu, grid, nv)
    return pts.reshape(b, nu.shape[0] * nv.shape[0], 3)


def _rotation_a_to_b(a, b):
    """Rotation R with b = R a for unit 3-vectors a, b (tensors), the
    identity where the frame [a, b', a x b] is degenerate
    (reference: src/fitting_utils.py:560-598)."""
    cos = torch.dot(a, b)
    cross = torch.linalg.cross(b, a)
    sin = torch.linalg.vector_norm(cross)
    v = b - cos * a
    v = v / (torch.linalg.vector_norm(v) + EPS)
    w = cross / (torch.linalg.vector_norm(cross) + EPS)
    f = torch.stack([a, v, w], 1)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    g = torch.stack([torch.stack([cos, -sin, zero]),
                     torch.stack([sin, cos, zero]),
                     torch.stack([zero, zero, one])])
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    r = f @ g @ torch.linalg.inv(f + EPS * eye)
    return torch.where(torch.linalg.det(f).abs() < 1e-10, eye, r)


def smallest_eigenvector(cov):
    """The eigenvector of the symmetric 3x3 cov (a tensor) for its smallest
    eigenvalue, by scipy's LAPACK on the host in float32 (see the module's
    docstring), with JAX's symmetrisation of the input first; returned on
    cov's device."""
    from scipy.linalg import eigh

    c = cov.detach().cpu().numpy().astype(np.float32)
    _, u = eigh((c + c.T) / np.float32(2.0), driver="evd")
    return torch.from_numpy(np.ascontiguousarray(u[:, 0])).to(cov.device)


def standardize_points(points, weights):
    """Weighted centre, rotate the smallest PCA axis onto +x, scale by the
    per-axis extent (reference: src/fitting_utils.py:512-553).

    points (N, 3), weights (N,). The points counted are those of weight
    above 0.8, or the top quarter (N >= 7500) or half by weight when fewer
    than 400 pass. R and std carry no gradient, as in JAX. Returns
    (std_points (N, 3), std (3,), mean (3,), R (3, 3))."""
    n = points.shape[0]
    conf = weights > 0.8
    k = n // 4 if n >= 7500 else n // 2
    thresh = torch.sort(weights).values[n - k]
    mask = torch.where(conf.sum() < 400, weights >= thresh, conf)
    mf = mask.to(points.dtype)[:, None]

    mean = (points * weights[:, None] * mf).sum(0) / (
        (weights * mask).sum() + EPS)
    centered = points - mean
    cm = centered * mf
    smallest = smallest_eigenvector(cm.T @ cm)
    r = _rotation_a_to_b(smallest, torch.tensor(
        [1.0, 0.0, 0.0], dtype=points.dtype, device=points.device))
    rotated = centered @ r.T
    wr = rotated * weights[:, None]
    big = torch.where(mf > 0, wr, -torch.inf).amax(0)
    small = torch.where(mf > 0, wr, torch.inf).amin(0)
    std = (big - small).abs().detach()
    return rotated / (std + EPS), std, mean, r


def reverse_transformation(points, mean, std, r):
    """Undo `standardize_points` (reference: src/fitting_utils.py:600-606)."""
    return (points * std.reshape(1, 3)) @ r + mean


def fit_control_points_kronecker(surface_points, nu, nv, lamb: float = 1e-6):
    """Least-squares control grid C minimising ||(Nu (x) Nv) vec(C) -
    vec(P)|| (reference: src/approximation.py
    fit_bezier_surface_fit_kronecker). surface_points (gu*gv, 3), nu, nv
    tensors; returns (cu*cv, 3)."""
    a = torch.kron(nu, nv)
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    return torch.linalg.solve(a.T @ a + lamb * eye, a.T @ surface_points)
