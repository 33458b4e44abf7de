"""Closed-form point-to-primitive distances and the residual dispatch.

Counterpart of `sednet_tpu/fit/residuals.py:21-246` (reference:
src/primitives.py:47-206). Distances are squared unless sqrt=True and are
reduced by their (optionally weighted) mean. `residual_loss_batched` runs
one padded call for every geometric segment and one masked chamfer call
for the splines of each surface size, as JAX does; the port pads to the
largest segment instead of JAX's power-of-two buckets, which only spared
XLA recompiles. Forward only: the chamfer is the port's `ops.chamfer`.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.ops.chamfer import chamfer_distance, nn_distance
from sednet_tpu_torch.ops.guard import guard_sqrt


def as_tensor(v, like):
    """A parameter (numpy, number or tensor) as float32 on like's device."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _reduce(distance, weights, sqrt, reduce):
    if sqrt:
        distance = guard_sqrt(distance)
    if not reduce:
        return distance
    if weights is None:
        return distance.mean()
    return (distance * weights).sum() / torch.clamp(weights.sum(), min=1e-8)


def distance_from_plane(points, normal, d, *, weights=None, sqrt=False,
                        reduce=True):
    """(n.x - d)^2 (reference: src/primitives.py:89-111)."""
    distance = (points @ as_tensor(normal, points).reshape(3)
                - as_tensor(d, points)) ** 2
    return _reduce(distance, weights, sqrt, reduce)


def distance_from_sphere(points, center, radius, *, weights=None, sqrt=False,
                         reduce=True):
    """(||x - c|| - r)^2 (reference: src/primitives.py:113-127)."""
    c = as_tensor(center, points).reshape(1, 3)
    distance = (torch.linalg.vector_norm(points - c, dim=1)
                - as_tensor(radius, points)) ** 2
    return _reduce(distance, weights, sqrt, reduce)


def distance_from_cylinder(points, axis, center, radius, *, weights=None,
                           sqrt=False, reduce=True):
    """(sqrt(||v||^2 - (v.a)^2) - r)^2
    (reference: src/primitives.py:129-161)."""
    a = as_tensor(axis, points).reshape(3)
    v = points - as_tensor(center, points).reshape(1, 3)
    lat = torch.clamp((v * v).sum(1) - (v @ a) ** 2, min=1e-5)
    distance = (torch.sqrt(lat) - as_tensor(radius, points)) ** 2
    return _reduce(distance, weights, sqrt, reduce)


def distance_from_cone(points, apex, axis, theta, *, weights=None, sqrt=False,
                       reduce=True):
    """(||v|| sin(min(|alpha - theta|, pi/2)))^2
    (reference: src/primitives.py:166-195)."""
    a = as_tensor(axis, points).reshape(3)
    v = points - as_tensor(apex, points).reshape(1, 3) + 1e-8
    mod_v = torch.linalg.vector_norm(v, dim=1)
    alpha = torch.arccos(torch.clamp((v @ a) / (mod_v + 1e-7), -0.999, 0.999))
    dist_angle = torch.clamp((alpha - as_tensor(theta, points)).abs(),
                             max=3.142 / 2.0)
    distance = (mod_v * torch.sin(dist_angle)) ** 2
    return _reduce(distance, weights, sqrt, reduce)


def distance_from_torus(points, axis, center, major_radius, minor_radius, *,
                        weights=None, sqrt=False, reduce=True):
    """Reference: src/primitives.py:58-87."""
    a = as_tensor(axis, points).reshape(3)
    a = a / torch.linalg.vector_norm(a)
    v = points - as_tensor(center, points).reshape(1, 3)
    z = v @ a
    x = guard_sqrt((v * v).sum(1) - z ** 2)
    big, small = as_tensor(major_radius, points), as_tensor(minor_radius,
                                                            points)
    right = (guard_sqrt((x - big) ** 2 + z ** 2) - small) ** 2
    left = (guard_sqrt((x + big) ** 2 + z ** 2) - small) ** 2
    return _reduce(torch.minimum(right, left), weights, sqrt, reduce)


def distance_from_bspline(points, surface_points, *, sqrt=False, reduce=True):
    """Chamfer proxy (reference: src/primitives.py:197-206)."""
    del reduce
    return chamfer_distance(as_tensor(surface_points, points)[None],
                            points[None], sqrt=sqrt)


def residual_loss(points_per_segment: Dict, parameters: Dict, sqrt=False):
    """Dispatch by primitive name (reference: src/primitives.py:36-44):
    parameters[k] = ("plane", n, d) etc., points_per_segment[k] a tensor.
    Returns {k: [name, distance]}; None parameters (skipped segments) are
    left out."""
    routines: Dict[str, Callable] = {
        "plane": lambda pts, p: distance_from_plane(pts, *p, sqrt=sqrt),
        "sphere": lambda pts, p: distance_from_sphere(pts, *p, sqrt=sqrt),
        "cylinder": lambda pts, p: distance_from_cylinder(pts, *p, sqrt=sqrt),
        "cone": lambda pts, p: distance_from_cone(pts, *p, sqrt=sqrt),
        "torus": lambda pts, p: distance_from_torus(pts, *p, sqrt=sqrt),
        "open-spline": lambda pts, p: distance_from_bspline(pts, p[0],
                                                            sqrt=sqrt),
        "closed-spline": lambda pts, p: distance_from_bspline(pts, p[0],
                                                              sqrt=sqrt),
    }
    return {k: [v[0], routines[v[0]](points_per_segment[k], v[1:])]
            for k, v in parameters.items() if v is not None}


GEOM_TYPE_IDS = {"plane": 0, "sphere": 1, "cylinder": 2, "cone": 3,
                 "torus": 4}


def pack_geom_params(v) -> np.ndarray:
    """(name, *params) -> flat (8,) float32: plane [n(3), d] / sphere [c(3),
    r] / cylinder [a(3), c(3), r] / cone [apex(3), axis(3), theta] / torus
    [axis(3), center(3), R, r]."""
    cat = np.concatenate([np.asarray(p, np.float32).reshape(-1)
                          for p in v[1:]])
    if cat.shape[0] > 8:
        raise ValueError(f"{v[0]}: {cat.shape[0]} parameters, at most 8")
    flat = np.zeros(8, np.float32)
    flat[: cat.shape[0]] = cat
    return flat


def _geom_residuals_padded(points, mask, type_ids, params, sqrt=False):
    """points (S, P, 3), mask (S, P), type_ids (S,) int64 in GEOM_TYPE_IDS'
    values, params (S, 8) -> (S,) masked-mean residuals, each branch the
    arithmetic of its `distance_from_*` above."""
    def dot(v, u):
        return (v @ u.unsqueeze(-1)).squeeze(-1)

    p3, q3 = params[:, None, :3], params[:, None, 3:6]
    r6, r7 = params[:, 6:7], params[:, 7:8]
    d_pl = (dot(points, params[:, :3]) - params[:, 3:4]) ** 2
    d_sp = (torch.linalg.vector_norm(points - p3, dim=-1)
            - params[:, 3:4]) ** 2
    v = points - q3
    vv_sq = (v * v).sum(-1)
    lat = torch.clamp(vv_sq - dot(v, params[:, :3]) ** 2, min=1e-5)
    d_cy = (torch.sqrt(lat) - r6) ** 2
    vc = points - p3 + 1e-8
    mod_v = torch.linalg.vector_norm(vc, dim=-1)
    alpha = torch.arccos(torch.clamp(dot(vc, params[:, 3:6]) / (mod_v + 1e-7),
                                     -0.999, 0.999))
    dang = torch.clamp((alpha - r6).abs(), max=3.142 / 2.0)
    d_co = (mod_v * torch.sin(dang)) ** 2
    ax = params[:, :3] / torch.linalg.vector_norm(params[:, :3], dim=-1,
                                                  keepdim=True)
    z = dot(v, ax)
    x = guard_sqrt(vv_sq - z ** 2)
    d_to = torch.minimum((guard_sqrt((x - r6) ** 2 + z ** 2) - r7) ** 2,
                         (guard_sqrt((x + r6) ** 2 + z ** 2) - r7) ** 2)
    d = torch.stack([d_pl, d_sp, d_cy, d_co, d_to], -1)
    d = torch.gather(d, -1, type_ids[:, None, None].expand(*d.shape[:2], 1))
    d = d[..., 0]
    if sqrt:
        d = guard_sqrt(d)
    return (d * mask).sum(1) / torch.clamp(mask.sum(1), min=1e-8)


def _spline_residuals_padded(gt, mask, surf, sqrt=False):
    """Masked batched symmetric chamfer: gt (S, P, 3) whose rows where
    mask == 0 move 1e6 away (so that they never win a nearest neighbour),
    surf (S, G, 3) -> (S,), 0.5 (mean over the surface + masked mean over
    the points), `chamfer_distance`'s convention."""
    far = gt + (1.0 - mask[..., None]) * 1e6
    d1, d2, _, _ = nn_distance(surf, far)
    if sqrt:
        d1 = torch.sqrt(torch.clamp(d1, min=1e-12))
        d2 = torch.sqrt(torch.clamp(d2, min=1e-12))
    m2 = (d2 * mask).sum(1) / torch.clamp(mask.sum(1), min=1e-8)
    return 0.5 * (d1.mean(1) + m2)


def _padded(items, device):
    """(points (S, P, 3), mask (S, P)) on device from numpy point arrays,
    P the largest."""
    p_max = max(p.shape[0] for p in items)
    pts = np.zeros((len(items), p_max, 3), np.float32)
    msk = np.zeros((len(items), p_max), np.float32)
    for i, p in enumerate(items):
        pts[i, : p.shape[0]] = p
        msk[i, : p.shape[0]] = 1.0
    return (torch.from_numpy(pts).to(device), torch.from_numpy(msk).to(device))


def residual_loss_batched(points_per_segment: Dict, parameters: Dict,
                          sqrt=False, device=None) -> Dict:
    """`residual_loss` in batched padded calls on `device` (None: the card):
    one for all geometric segments, one for the splines of each surface
    size; points_per_segment holds numpy arrays, a spline's surface may be
    a tensor on the device. One device-to-host copy a call. Returns {k:
    [name, residual as a numpy float32 scalar]}."""
    dev = resolve_device(device)
    geom, spline = [], {}
    for k, v in parameters.items():
        if v is None:
            continue
        pts = np.asarray(points_per_segment[k], np.float32)
        if v[0] in GEOM_TYPE_IDS:
            geom.append((k, v[0], pts, pack_geom_params(v)))
        else:
            spline.setdefault(v[1].shape[0], []).append((k, v[0], pts, v[1]))
    out = {}
    if geom:
        pts, msk = _padded([g[2] for g in geom], dev)
        tid = torch.tensor([GEOM_TYPE_IDS[g[1]] for g in geom],
                           dtype=torch.int64, device=dev)
        par = torch.from_numpy(np.stack([g[3] for g in geom])).to(dev)
        res = _geom_residuals_padded(pts, msk, tid, par, sqrt=sqrt).cpu()
        for i, (k, name, _, _) in enumerate(geom):
            out[k] = [name, res[i].numpy()]
    for items in spline.values():
        pts, msk = _padded([it[2] for it in items], dev)
        srf = torch.stack([as_tensor(it[3], pts) for it in items])
        res = _spline_residuals_padded(pts, msk, srf, sqrt=sqrt).cpu()
        for i, (k, name, _, _) in enumerate(items):
            out[k] = [name, res[i].numpy()]
    return out
