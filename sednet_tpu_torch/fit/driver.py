"""Per-shape fitting driver: segment dispatch to the primitive fits or to
SplineNet.

Counterpart of `sednet_tpu/fit/driver.py:45-313` (reference:
src/fitting_optimization.py:117-245, src/primitive_forward.py:929-1051):

  * type dispatch: {0, 9, 6, 7} closed spline, 1 plane, 3 cone,
    4 cylinder, 5 sphere, {2, 8} open spline;
  * guards: fewer than 20 points -> skipped; splines need 100; in eval
    mode a spline segment loses its statistical outliers and is resampled
    to 1800 (closed) or 1500 (open) points, with the draws of JAX's
    `np.random.RandomState` in JAX's order;
  * the geometric segments of a call run as one padded batch on the
    device with one device-to-host copy; splines go one at a time
    (standardise, SplineNet, sample the control grid, undo the
    standardisation; a closed spline wraps its first row);
  * the optional refit (ARAP, Hungarian matching, least squares) runs on
    the host in numpy and scipy, as in JAX.

The entry points run on the fitter's device: the card unless the caller
names the CPU.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.fit.bspline import (basis_function_one,
                                          reverse_transformation,
                                          sample_from_control_grid,
                                          standardize_points,
                                          uniform_knot_bspline)
from sednet_tpu_torch.fit.primitives import (fit_all_types_packed,
                                             unpack_fit_params)
from sednet_tpu_torch.utils.chunked import chunked_sqdist_blocks

EPS = 1e-8

CLOSED_SPLINE_LABELS = (0, 9, 6, 7)
OPEN_SPLINE_LABELS = (2, 8)
GEOMETRIC_LABELS = {1: "plane", 3: "cone", 4: "cylinder", 5: "sphere"}


def remove_outliers(points: np.ndarray, nb_neighbors: int = 20,
                    std_ratio: float = 0.5, return_mask: bool = False):
    """Statistical outlier removal: keep the points whose mean distance to
    their nb_neighbors nearest is at most mean + std_ratio * std (the
    open3d filter of src/fitting_utils.py:704-710). With return_mask, also
    the boolean keep mask."""
    n = points.shape[0]
    k = min(nb_neighbors + 1, n)
    mean_d = np.empty(n, np.float32)
    for lo, hi, d2 in chunked_sqdist_blocks(points, points):
        nn = np.sort(d2, axis=1)[:, 1:k]
        mean_d[lo:hi] = np.sqrt(np.clip(nn, 0, None)).mean(1)
    keep = mean_d <= mean_d.mean() + std_ratio * mean_d.std()
    if return_mask:
        return points[keep], keep
    return points[keep]


def up_sample_points_in_range(points: np.ndarray, weights: np.ndarray,
                              a_min: int, a_max: int,
                              rng: np.random.RandomState | None = None):
    """Resample to exactly a_max points: add the centroids of each point's 5
    nearest while there are fewer, then draw a_max without replacement
    (reference: src/fitting_utils.py:149-237, which ignores a_min too)."""
    rng = rng or np.random.RandomState(0)
    while points.shape[0] < a_max:
        _, _, d2 = next(chunked_sqdist_blocks(points, points,
                                              block=points.shape[0]))
        idx = np.argsort(d2, axis=1)[:, :5]
        points = np.concatenate([points, points[idx].mean(1)])
        weights = np.concatenate([weights, weights])
    sel = rng.choice(points.shape[0], a_max, replace=False)
    return points[sel], weights[sel]


class FittingModule:
    """The SplineNets and basis matrices; fits one spline segment at a time
    and records the parameters of every segment `fit_one_shape` fits
    (reference: src/fitting_optimization.py:117-245). JAX's single-segment
    geometric methods (`forward_pass_plane` and the like), which nothing
    calls, are not ported: `fit_one_shape` fits geometric segments in one
    batch.

    open_spline_net / closed_spline_net: `models.splinenet.SplineNet`s with
    their weights (JAX's FittingModule takes flax variables for one shared
    module), moved to `device` (None: the card)."""

    def __init__(self, open_spline_net=None, closed_spline_net=None,
                 grid_size: int = 20, sample_grid: int = 30, k: int = 10,
                 device=None):
        self.device = resolve_device(device)
        self.nu, self.nv = uniform_knot_bspline(grid_size, grid_size, 3, 3,
                                                sample_grid)
        self.nu_t = torch.from_numpy(self.nu).to(self.device)
        self.nv_t = torch.from_numpy(self.nv).to(self.device)
        self.grid_size, self.sample_grid, self.k = grid_size, sample_grid, k
        self.open_net = self._net(open_spline_net)
        self.closed_net = self._net(closed_spline_net)
        self.parameters: Dict[Any, Any] = {}

    def _net(self, net):
        if net is None:
            return None
        if (net.grid_size, net.k) != (self.grid_size, self.k):
            raise ValueError(f"SplineNet grid {net.grid_size}, k {net.k}: "
                             f"the fitter has {self.grid_size}, {self.k}")
        return net.to(self.device).eval()

    def _spline_forward(self, points, weights, net):
        """Standardise, SplineNet, sample the control grid, undo the
        standardisation: the (sample_grid^2, 3) surface."""
        std_pts, std, mean, r = standardize_points(points, weights)
        control = net(std_pts[None], weights=weights[None])
        recon = sample_from_control_grid(self.nu_t, self.nv_t, control,
                                         self.grid_size, self.grid_size)[0]
        return reverse_transformation(recon, mean, std, r)

    def _refit(self, recon, points, closed):
        return torch.from_numpy(optimize_spline_kronecker(
            recon.cpu().numpy(), points.cpu().numpy(),
            closed=closed)).to(self.device)

    def forward_pass_open_spline(self, points, weights, ids,
                                 if_optimize=False):
        if self.open_net is None:
            raise ValueError("open SplineNet weights not loaded")
        recon = self._spline_forward(points, weights, self.open_net)
        if if_optimize:
            recon = self._refit(recon, points, closed=False)
        self.parameters[ids] = ["open-spline", recon]
        return recon

    def forward_pass_closed_spline(self, points, weights, ids,
                                   if_optimize=False):
        if self.closed_net is None:
            raise ValueError("closed SplineNet weights not loaded")
        recon = self._spline_forward(points, weights, self.closed_net)
        # wrap the closed direction (reference: primitive_forward.py:385-397)
        g = self.sample_grid
        recon = recon.reshape(g, g, 3)
        recon = torch.cat([recon, recon[0:1]], 0).reshape(-1, 3)
        if if_optimize:
            recon = self._refit(recon, points, closed=True)
        self.parameters[ids] = ["closed-spline", recon]
        return recon


def basis_matrix(params: np.ndarray, n_ctrl: int, degree: int) -> np.ndarray:
    """(P,) parameter values -> (P, n_ctrl) B-spline basis rows."""
    knots = ([0.0] * degree
             + np.arange(0, 1.01, 1.0 / (n_ctrl - degree)).tolist()
             + [1.0] * degree)
    out = np.zeros((params.shape[0], n_ctrl))
    for i, u in enumerate(params):
        for j in range(n_ctrl):
            out[i, j] = basis_function_one(degree, knots, j, min(u, 1.0 - 1e-9))
    return out


def optimize_spline_kronecker(recon: np.ndarray, input_points: np.ndarray,
                              closed: bool = False, new_cp: int = 10,
                              degree: int = 3, grid: int = 30,
                              deform: bool = True) -> np.ndarray:
    """Refit on the host: ARAP-deform the predicted grid toward the input
    cloud, Hungarian-match surface samples to the cloud, and fit a fresh
    control grid through the matches by least squares (reference:
    optimize_*_spline_kronecker with deform=True,
    src/primitive_forward.py:157-300; ARAP
    src/fitting_optimization.py:32-114)."""
    from scipy.optimize import linear_sum_assignment

    pts = recon.reshape(-1, 3)
    if deform and input_points.shape[0] >= 30:
        from sednet_tpu_torch.fit.arap import arap_deform

        n = pts.shape[0]
        if closed:  # wrapped grid: (sv + 1) x sv vertices
            sv = int(round((np.sqrt(4 * n + 1) - 1) / 2))
            su = sv + 1
        else:
            su = sv = int(round(np.sqrt(n)))
        if su * sv == n and su >= 3 and sv >= 3:
            pts = arap_deform(pts, input_points, su, sv)
    m = min(input_points.shape[0], pts.shape[0])
    pts_s = pts[np.linspace(0, pts.shape[0] - 1, m).astype(int)]
    d = np.linalg.norm(pts_s[:, None] - input_points[None], axis=2)
    _, cids = linear_sum_assignment(d)
    matched = input_points[cids]

    uv = np.stack(np.meshgrid(np.linspace(0, 1, grid),
                              np.linspace(0, 1, grid)), -1).reshape(-1, 2)
    uv = uv[np.linspace(0, uv.shape[0] - 1, m).astype(int)]
    nu = basis_matrix(uv[:, 0], new_cp, degree)
    nv = basis_matrix(uv[:, 1], new_cp, degree)
    a = np.einsum("pi,pj->pij", nu, nv).reshape(m, new_cp * new_cp)
    ata = a.T @ a + 1e-6 * np.eye(new_cp * new_cp)
    ctrl = np.linalg.solve(ata, a.T @ matched)

    gu = basis_matrix(np.linspace(0, 1 - 1e-9, grid), new_cp, degree)
    surface = np.einsum("ui,ijc,vj->uvc", gu, ctrl.reshape(new_cp, new_cp, 3),
                        gu).reshape(-1, 3)
    if closed:
        surface = surface.reshape(grid, grid, 3)
        surface = np.concatenate([surface, surface[0:1]], 0).reshape(-1, 3)
    return surface.astype(np.float32)


def _batched_geometric_fits(geo, fitter: FittingModule):
    """Fit every geometric segment in one call on the fitter's device and
    fetch the (S, 22) packed fits with one copy. geo: list of (sid, label,
    pts, nrm, w) numpy tuples, padded to the largest segment with zero
    points and zero weight, which leave every fit unchanged."""
    p_max = max(p.shape[0] for _, _, p, _, _ in geo)
    pts = np.zeros((len(geo), p_max, 3), np.float32)
    nrm = np.zeros((len(geo), p_max, 3), np.float32)
    w = np.zeros((len(geo), p_max), np.float32)
    for i, (_, _, p, n, ww) in enumerate(geo):
        m = p.shape[0]
        pts[i, :m], nrm[i, :m], w[i, :m] = p, n, ww
    dev = fitter.device
    packed = fit_all_types_packed(
        torch.from_numpy(pts).to(dev), torch.from_numpy(nrm).to(dev),
        torch.from_numpy(w).to(dev)).cpu().numpy()
    for i, (sid, label, _, _, _) in enumerate(geo):
        name = GEOMETRIC_LABELS[label]
        fitter.parameters[sid] = [name] + unpack_fit_params(packed[i], name)


@torch.no_grad()
def fit_one_shape(segments, fitter: FittingModule, *, eval_mode=False,
                  if_optimize=False, rng=None):
    """Fit every segment of one shape (or of many: the ids only need to be
    distinct).

    segments: dicts with keys points (N, 3), normals (N, 3) or None, label
    (type id), weights (N,) (default ones) and id, numpy on the host.
    Returns (parameters, reconstructions): parameters[id] is None for a
    skipped segment, [name, *params] otherwise (numpy for a geometric
    fit, the surface tensor on the fitter's device for a spline);
    reconstructions[id] is a spline's surface, else None
    (reference: primitive_forward.py:929-1051)."""
    rng = rng or np.random.RandomState(0)
    dev = fitter.device
    fitter.parameters = {}
    recon = {}
    geo = []
    for seg in segments:
        sid = seg["id"]
        label = int(seg["label"])
        pts = np.asarray(seg["points"], np.float32)
        nrm = np.asarray(seg.get("normals"), np.float32) \
            if seg.get("normals") is not None else np.zeros_like(pts)
        w = np.asarray(seg.get("weights",
                               np.ones(pts.shape[0], np.float32))) + EPS
        recon[sid] = None

        spline = label in CLOSED_SPLINE_LABELS or label in OPEN_SPLINE_LABELS
        if pts.shape[0] < 20 or (spline and pts.shape[0] < 100) or not (
                spline or label in GEOMETRIC_LABELS):
            fitter.parameters[sid] = None
            continue
        if label in GEOMETRIC_LABELS:
            geo.append((sid, label, pts, nrm, w))
            continue
        closed = label in CLOSED_SPLINE_LABELS
        if eval_mode:
            kept, keep = remove_outliers(pts, return_mask=True)
            lo, hi = (1400, 1800) if closed else (1000, 1500)
            pts, w = up_sample_points_in_range(kept, w[keep], lo, hi, rng)
        pj = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        wj = torch.from_numpy(np.asarray(w[: pts.shape[0]],
                                         np.float32)).to(dev)
        forward = (fitter.forward_pass_closed_spline if closed
                   else fitter.forward_pass_open_spline)
        recon[sid] = forward(pj, wj, sid, if_optimize=if_optimize)
    if geo:
        _batched_geometric_fits(geo, fitter)
    return fitter.parameters, recon
