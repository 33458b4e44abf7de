"""Robust ("v2") primitive fits used by the patch/edge post-processing.

A numpy copy of `sednet_tpu/postproc/robust_fits.py`; the same arithmetic in the
same order, so that both packages write the same files.

Rebuild of the reference's fork Fit (Fitting_patches_and_edges/
primitive_forward_v2.py:716-891) + circle_fit_utils.py:43-113. These add
robustness tricks over the base fits in sednet_tpu.fit.primitives:
  * plane: keep the nearest `filter_ratio` (default 0.5) of points to the
    segment centroid before the SVD fit (:716-728);
  * cylinder: keep the nearest third if >600 points; axis from the weighted
    normals' null space; radius/center via a 2-D algebraic circle fit after
    rotating the projected points into the z=0 plane (:823-849);
  * cone: keep the nearest half; apex LS; axis snapped to a coordinate axis
    when nearly aligned; small apex coordinates zeroed (:851-891);
  * sphere: unchanged from the base fit.

Host-side numpy: this runs on <=50 instances per shape in the branchy
post-processing stage (SURVEY §7.2 step 9), not on the training path.
"""
from __future__ import annotations

import numpy as np

EPS = 1e-8


def rodrigues_rot(points: np.ndarray, n0, n1) -> np.ndarray:
    """Rotate points by the rotation taking unit vector n0 to n1
    (reference: circle_fit_utils.py rodrigues_rot)."""
    points = np.atleast_2d(points)
    n0 = np.asarray(n0, float) / np.linalg.norm(n0)
    n1 = np.asarray(n1, float) / np.linalg.norm(n1)
    k = np.cross(n0, n1)
    if np.linalg.norm(k) < 1e-12:
        return points.copy() if np.dot(n0, n1) > 0 else -points
    k = k / np.linalg.norm(k)
    theta = np.arccos(np.clip(np.dot(n0, n1), -1.0, 1.0))
    rotated = (points * np.cos(theta)
               + np.cross(k, points) * np.sin(theta)
               + k[None, :] * (points @ k)[:, None] * (1 - np.cos(theta)))
    return rotated


def fit_circle_2d(x: np.ndarray, y: np.ndarray, w=()):
    """Algebraic (Kasa) 2-D circle fit (reference: circle_fit_utils.py:43-61).
    Returns (xc, yc, r)."""
    a = np.stack([x, y, np.ones_like(x)], 1)
    b = x ** 2 + y ** 2
    if len(w) == len(x):
        a = np.diag(w) @ a
        b = np.diag(w) @ b
    c = np.linalg.lstsq(a, b, rcond=None)[0]
    xc, yc = c[0] / 2, c[1] / 2
    r = np.sqrt(max(c[2] + xc ** 2 + yc ** 2, EPS))
    return xc, yc, r


def circle_segmentation(cloud: np.ndarray):
    """Fit a 3-D circle: SVD plane fit -> rotate into z=0 -> 2-D circle fit
    -> rotate back (reference: circle_fit_utils.py:75-113).
    Returns (center (3,), radius, plane normal)."""
    mean = cloud.mean(0)
    centered = cloud - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    normal = vt[2]
    xy = rodrigues_rot(centered, normal, [0, 0, 1])
    xc, yc, r = fit_circle_2d(xy[:, 0], xy[:, 1])
    center = rodrigues_rot(np.array([xc, yc, 0.0]), [0, 0, 1], normal)[0] + mean
    return center, float(r), normal


def _nearest_fraction(points, *arrays, fraction=0.5):
    """Keep the `fraction` of points nearest the centroid
    (v2 filter, primitive_forward_v2.py:721-727)."""
    center = points.mean(0, keepdims=True)
    order = np.argsort(((points - center) ** 2).sum(-1))
    keep = order[: max(int(order.shape[0] * fraction), 3)]
    return (points[keep],) + tuple(a[keep] for a in arrays)


class RobustFitter:
    """v2 fits; parameter tuples match sednet_tpu.fit conventions:
    ("plane", n, d), ("sphere", c, r), ("cylinder", a, c, r),
    ("cone", apex, a, theta)."""

    def __init__(self, plane_filter_ratio: float = 0.5):
        self.plane_filter_ratio = plane_filter_ratio

    def fit_plane(self, points, normals, weights=None, nofilter=False):
        # weights ride the SAME nearest-fraction index as the points — the
        # reference indexes all three by `index` (primitive_forward_v2.py:
        # 722-727); truncating by count would pair points with unrelated
        # weights after the distance sort
        w = np.ones((points.shape[0], 1)) if weights is None else \
            weights.reshape(-1, 1)
        if not nofilter:
            if normals is None:
                points, w = _nearest_fraction(
                    points, w, fraction=self.plane_filter_ratio)
            else:
                points, normals, w = _nearest_fraction(
                    points, normals, w, fraction=self.plane_filter_ratio)
        wsum = w.sum() + EPS
        x = points - (w * points).sum(0, keepdims=True) / wsum
        _, s, vt = np.linalg.svd(w * x, full_matrices=False)
        a = vt[-1]
        d = float((w[:, 0] * (points @ a)).sum() / wsum)
        return "plane", a, d

    def fit_sphere(self, points, normals=None, weights=None):
        w = np.ones((points.shape[0], 1)) if weights is None else \
            weights.reshape(-1, 1)
        wsum = w.sum() + EPS
        a = 2.0 * (-points + (points * w).sum(0) / wsum)
        dot = w * (points * points).sum(1, keepdims=True)
        y = dot - dot.sum() / wsum
        center = -np.linalg.lstsq(w * a, w * y, rcond=None)[0][:, 0]
        r = np.sqrt(max(
            (w[:, 0] * ((points - center) ** 2).sum(1)).sum() / wsum, 1e-6))
        return "sphere", center, float(r)

    def fit_cylinder(self, points, normals, weights=None):
        w = np.ones((points.shape[0], 1)) if weights is None else \
            weights.reshape(-1, 1)
        wn = w * normals
        if wn.shape[0] > 600:
            points, wn = _nearest_fraction(points, wn, fraction=1.0 / 3.0)
        _, _, vt = np.linalg.svd(wn, full_matrices=False)
        a = vt[-1]
        a = a / (np.linalg.norm(a) + EPS)
        prj = points - (points @ a)[:, None] * a[None, :]
        center, radius, _ = circle_segmentation(prj)
        return "cylinder", a, center, float(radius)

    def fit_cone(self, points, normals, weights=None):
        w = np.ones((points.shape[0], 1)) if weights is None else \
            weights.reshape(-1, 1)
        points, normals, w = _nearest_fraction(points, normals, w,
                                               fraction=0.5)
        y = (normals * points).sum(1, keepdims=True)
        apex = np.linalg.lstsq(normals, y, rcond=None)[0][:, 0]

        # axis = plane fit of the *normals* (primitive_forward_v2.py:862-866)
        _, a, _ = self.fit_plane(normals, None, nofilter=True)
        if np.dot(apex - points[0], a) < 0:
            a = -a
        # v2 tricks: snap near-axis-aligned axes, zero small apex coordinates
        # (primitive_forward_v2.py:869-877)
        for i in range(3):
            if abs(a[i]) >= 0.98:
                sign = 1.0 if a[i] > 0 else -1.0
                a = np.zeros(3)
                a[i] = sign
                break
        apex = np.where(np.abs(apex) <= 0.1, 0.0, apex)

        diff = points - apex[None, :]
        diff = diff / (np.linalg.norm(diff, axis=1, keepdims=True) + EPS)
        cos = np.clip(np.abs(diff @ a), None, 0.999)
        theta = float((w[:, 0] * np.arccos(cos)).sum() / (w.sum() + EPS))
        theta = float(np.clip(theta, 1e-3, 3.142 / 2 - 1e-3))
        return "cone", apex, a, theta
