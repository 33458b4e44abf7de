"""Analytic pairwise intersection curves and corner points.

A numpy copy of `sednet_tpu/postproc/intersections.py`; the same arithmetic in the
same order, so that both packages write the same files.

Rebuild of reference Fitting_patches_and_edges/proj_2_edge_utils.py:142-659.
Curves are returned as tagged tuples matching the reference's
inter_para_set vocabulary (consumed by arg2mesh):
  ("line", k (3,), d (3,))                      — p(t) = d + t k
  ("circle", center, x_axis, y_axis, radius)    — p(a) = c + r(cos a x + sin a y)
  ("ellipse", center, x_axis, y_axis, rx, ry)
  (None,) if no (usable) intersection.
Primitive parameter tuples follow sednet_tpu.fit: ("plane", n, d),
("cylinder", a, c, r), ("cone", apex, a, theta), ("sphere", c, r).
"""
from __future__ import annotations

import numpy as np

EPS = 1e-8


def _unit(v):
    return v / (np.linalg.norm(v) + EPS)


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + EPS))


def project_to_plane(points: np.ndarray, n: np.ndarray, d: float) -> np.ndarray:
    """Project points onto the plane {x: n.x = d}
    (reference: src/fitting_utils.py:624-633)."""
    n = _unit(np.asarray(n, float).reshape(3))
    prj = points - (points @ n)[:, None] * n[None, :]
    return prj + n[None, :] * d


def circle_plane_axes(axis: np.ndarray):
    """Orthonormal (x_axis, y_axis) spanning the plane orthogonal to axis
    (reference: proj_2_edge_utils.py get_circle_x_y_axis)."""
    axis = _unit(np.asarray(axis, float).reshape(3))
    h = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1, 0])
    x_axis = _unit(np.cross(axis, h))
    y_axis = _unit(np.cross(x_axis, axis))
    return x_axis, y_axis


def plane_plane(p1, p2, parallel_cos: float = 0.98):
    """Two planes -> line (reference: proj_2_edge_utils.py:142-175)."""
    a1, d1 = np.asarray(p1[1], float).reshape(3), float(p1[2])
    a2, d2 = np.asarray(p2[1], float).reshape(3), float(p2[2])
    if abs(_cos(a1, a2)) >= parallel_cos:
        return (None,)
    k = _unit(np.cross(a1, a2))
    # base point: solve the two plane equations with the best-conditioned
    # coordinate fixed to zero (reference tries z=0, x=0, y=0)
    best = None
    for drop in (2, 0, 1):
        keep = [i for i in range(3) if i != drop]
        a = np.array([[a1[keep[0]], a1[keep[1]]], [a2[keep[0]], a2[keep[1]]]])
        if abs(np.linalg.det(a)) < 1e-8:
            continue
        xy = np.linalg.solve(a, np.array([d1, d2]))
        base = np.zeros(3)
        base[keep[0]], base[keep[1]] = xy
        if best is None or np.abs(base).max() < np.abs(best).max():
            best = base
    if best is None:
        return (None,)
    return ("line", k, best)


def plane_cylinder(plane, cyl, *, perp_cos=1.5e-2, par_cos=1e-2,
                   preferred_point=None):
    """Plane x cylinder -> line / two lines (pick the one near
    preferred_point) / circle / ellipse
    (reference: proj_2_edge_utils.py:198-264)."""
    a1, d1 = np.asarray(plane[1], float).reshape(3), float(plane[2])
    a2 = np.asarray(cyl[1], float).reshape(3)
    center = np.asarray(cyl[2], float).reshape(3)
    radius = float(cyl[3])
    cos = _cos(a1, a2)

    if abs(cos) <= perp_cos:
        # axis parallel to the plane: line(s)
        proj_center = project_to_plane(center[None], a1, d1)[0]
        t = radius ** 2 - ((proj_center - center) ** 2).sum()
        if t < -1e-3:
            return (None,)
        proj_dir = _unit(np.cross(a1, a2))
        if abs(t) <= 1e-3:  # tangent
            return ("line", a2, proj_center)
        half = np.sqrt(t)
        b1 = proj_center + half * proj_dir
        b2 = proj_center - half * proj_dir
        if preferred_point is not None:
            if (np.linalg.norm(b1 - preferred_point)
                    > np.linalg.norm(b2 - preferred_point)):
                b1, b2 = b2, b1
            return ("line", a2, b1)
        return ("two-line", a2, b1, b2)
    if 1 - abs(cos) <= par_cos:
        proj_center = project_to_plane(center[None], a1, d1)[0]
        x_axis, y_axis = circle_plane_axes(a2)
        return ("circle", proj_center, x_axis, y_axis, radius)
    # oblique: ellipse. Center = point on the axis lying in the plane.
    t = (d1 - np.dot(a1, center)) / (np.dot(a1, a2) + EPS)
    e_center = center + t * a2
    proj_center = project_to_plane(center[None], a1, d1)[0]
    x_axis = _unit(e_center - proj_center) if np.linalg.norm(
        e_center - proj_center) > 1e-9 else circle_plane_axes(a1)[0]
    y_axis = _unit(np.cross(x_axis, a1))
    return ("ellipse", e_center, x_axis, y_axis, radius / (abs(cos) + EPS),
            radius)


def plane_cone(plane, cone, *, align_cos=0.98):
    """Plane orthogonal to the cone axis -> circle
    (reference: proj_2_edge_utils.py:266-286)."""
    a1, d1 = np.asarray(plane[1], float).reshape(3), float(plane[2])
    apex = np.asarray(cone[1], float).reshape(3)
    a2 = np.asarray(cone[2], float).reshape(3)
    theta = float(cone[3])
    if abs(_cos(a1, a2)) < align_cos:
        return (None,)
    proj_center = project_to_plane(apex[None], a1, d1)[0]
    radius = np.linalg.norm(proj_center - apex) * np.tan(theta)
    x_axis, y_axis = circle_plane_axes(a2)
    return ("circle", proj_center, x_axis, y_axis, float(radius))


def cylinder_cone(cyl, cone, *, align_cos=0.98):
    """Coaxial cylinder/cone -> circle at matching radius
    (reference: proj_2_edge_utils.py:288-307)."""
    a1 = np.asarray(cyl[1], float).reshape(3)
    r1 = float(cyl[3])
    apex = np.asarray(cone[1], float).reshape(3)
    a2 = np.asarray(cone[2], float).reshape(3)
    theta = float(cone[3])
    if abs(_cos(a1, a2)) < align_cos:
        return (None,)
    h = r1 / np.tan(theta)
    # the reference's flip test cos(apex - center, a2) < 0 is identically
    # true for center = apex + a2*h, so its EFFECTIVE behavior is always
    # center = apex - a2*h — correct for the v2 cone convention where the
    # axis points from the body toward the apex
    # (proj_2_edge_utils.py:297-300)
    center = apex - a2 * h
    x_axis, y_axis = circle_plane_axes(a1)
    return ("circle", center, x_axis, y_axis, r1)


def plane_sphere(plane, sphere):
    """Plane x sphere -> circle (reference: proj_2_edge_utils.py:309-321)."""
    a, d = np.asarray(plane[1], float).reshape(3), float(plane[2])
    center = np.asarray(sphere[1], float).reshape(3)
    radius = float(sphere[2])
    proj = project_to_plane(center[None], a, d)[0]
    dist = np.linalg.norm(proj - center)
    if dist >= radius:
        return (None,)
    x_axis, y_axis = circle_plane_axes(a)
    return ("circle", proj, x_axis, y_axis,
            float(np.sqrt(radius ** 2 - dist ** 2)))


def cylinder_sphere(cyl, sphere):
    """Coarse circle at sphere center with cylinder radius
    (reference: proj_2_edge_utils.py:326-331)."""
    a1 = np.asarray(cyl[1], float).reshape(3)
    r1 = float(cyl[3])
    center = np.asarray(sphere[1], float).reshape(3)
    x_axis, y_axis = circle_plane_axes(a1)
    return ("circle", center, x_axis, y_axis, r1)


def intersect(par1, par2, *, preferred_point=None):
    """Dispatch on the pair of primitive names; symmetric. Returns a curve
    tuple or (None,) (reference: primitive_forward_v2.py:1216-1396
    dispatch; cylinder/cylinder is unimplemented in the reference too)."""
    if par1 is None or par2 is None:
        return (None,)
    n1, n2 = par1[0], par2[0]
    table = {
        ("plane", "plane"): lambda: plane_plane(par1, par2),
        ("plane", "cylinder"): lambda: plane_cylinder(
            par1, par2, preferred_point=preferred_point),
        ("cylinder", "plane"): lambda: plane_cylinder(
            par2, par1, preferred_point=preferred_point),
        ("plane", "cone"): lambda: plane_cone(par1, par2),
        ("cone", "plane"): lambda: plane_cone(par2, par1),
        ("cylinder", "cone"): lambda: cylinder_cone(par1, par2),
        ("cone", "cylinder"): lambda: cylinder_cone(par2, par1),
        ("plane", "sphere"): lambda: plane_sphere(par1, par2),
        ("sphere", "plane"): lambda: plane_sphere(par2, par1),
        ("cylinder", "sphere"): lambda: cylinder_sphere(par1, par2),
        ("sphere", "cylinder"): lambda: cylinder_sphere(par2, par1),
    }
    fn = table.get((n1, n2))
    return fn() if fn else (None,)


def line_line_intersection(k1, d1, k2, d2, tol: float = 1.1):
    """Closest point between two lines via LS; None when they don't meet
    within tol (reference: proj_2_edge_utils.py:376-398)."""
    k1, d1 = _unit(np.asarray(k1, float)), np.asarray(d1, float).reshape(3)
    k2, d2 = _unit(np.asarray(k2, float)), np.asarray(d2, float).reshape(3)
    # unknowns: t1, t2, xyz;  d + t k - xyz = 0 for both lines
    a = np.zeros((6, 5))
    a[:3, 0] = k1
    a[3:, 1] = k2
    a[:3, 2:] = -np.eye(3)
    a[3:, 2:] = -np.eye(3)
    y = -np.concatenate([d1, d2])
    x, *_ = np.linalg.lstsq(a, y, rcond=None)
    point = x[2:5]
    if np.abs(point).max() <= tol:
        # require the lines to actually (nearly) meet
        r1 = np.linalg.norm(np.cross(point - d1, k1))
        r2 = np.linalg.norm(np.cross(point - d2, k2))
        if max(r1, r2) < 0.05:
            return point
    return None


def line_circle_intersection(line, circle, tol: float = 5e-3):
    """Line x circle, coplanar or near-coplanar case
    (reference: proj_2_edge_utils.py:400-478). Returns tuple of points or
    None."""
    k, d = _unit(np.asarray(line[0], float)), np.asarray(line[1], float)
    center = np.asarray(circle[0], float).reshape(3)
    x_axis = _unit(np.asarray(circle[1], float))
    y_axis = _unit(np.asarray(circle[2], float))
    radius = float(circle[3])
    n = _unit(np.cross(x_axis, y_axis))

    # distance of the circle center from the line
    v = center - d
    along = np.dot(v, k)
    perp = v - along * k
    dist = np.linalg.norm(perp)
    # nearest point on line to the center
    c_proj = d + along * k

    if abs(np.dot(k, n)) < 0.05:  # line ~parallel to circle plane
        if dist > radius + tol:
            return None
        if abs(radius - dist) <= tol:
            return (c_proj,)
        half = np.sqrt(max(radius ** 2 - dist ** 2, 0.0))
        return (c_proj + half * k, c_proj - half * k)

    # general case: intersect the line with the circle's plane
    denom = np.dot(k, n)
    t = np.dot(center - d, n) / denom
    p = d + t * k
    if abs(np.linalg.norm(p - center) - radius) < 2e-2:
        return (p,)
    return None
