"""Trimmed-mesh generation from fitted parameters + intersection curves.

A numpy copy of `sednet_tpu/postproc/arg2mesh.py`; the same arithmetic in the
same order, so that both packages write the same files.

Rebuild of reference arg2mesh/arg2mesh.py (:16-803): consumes
param_{id}.txt and param_inter_lines_{id}.json (as written by
postproc.pipeline.save_shape_parameters) and emits per-instance
OBJ meshes with vertex colors plus a combined OBJ.

Per primitive:
  * plane: boundary curves (trimmed lines + circles discretized to chords,
    reference :76-95) are projected into plane coordinates and walked into
    closed loops (multiple loops supported, reference get_polygon_set
    :237-332); the largest-area loop is the outer boundary, smaller loops
    become holes (reference :89-105), and the face is triangulated by a
    from-scratch ear-clipping CDT with hole bridging (replacing the
    reference's `triangle` library, :14,107-111) — non-convex and holed
    faces mesh correctly;
  * cylinder/cone: lateral band between the bottom/top boundary circles,
    clipped to the circles' ANGULAR range (partial-angle surfaces stay
    open, reference doubleCircleEdge_mesh/sample_circleEdge_absCoord
    :346-403) and to the axial range; full ring only when no circle
    boundary exists;
  * sphere: UV sphere (clipped to the side of a single circle cut when one
    exists, reference sphere_mesh :405-442).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List

import numpy as np

from sednet_tpu_torch.utils.vis import COLORS_TYPE

TWO_PI = 2 * np.pi
CIRCLE_V = 64


def save_obj(path: str, vertices: np.ndarray, faces: List[List[int]],
             colors: np.ndarray | None = None) -> None:
    """OBJ with optional per-vertex colors (reference: arg2mesh.py:642-664).
    faces are 1-indexed."""
    with open(path, "w") as f:
        for i, v in enumerate(vertices):
            line = f"v {v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = colors[i]
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        f.write("\n")
        for face in faces:
            f.write("f " + " ".join(str(i) for i in face) + "\n")


def parse_param_file(path: str) -> Dict[int, list]:
    """Parse param_{id}.txt (format written by save_shape_parameters)."""
    out = {}
    num = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")
    for line in open(path):
        m = re.match(r"id (\S+):\s*(.*)", line.strip())
        if not m:
            continue
        key = int(m.group(1))
        parts = [p.strip() for p in m.group(2).split(",") if p.strip()]
        name = parts[0]
        vals = [np.array([float(x) for x in num.findall(p)]) for p in parts[1:]]
        vals = [v.item() if v.size == 1 else v for v in vals]
        out[key] = [name] + vals
    return out


def parse_inter_lines(path: str) -> Dict[int, Dict[int, list]]:
    raw = json.load(open(path))
    out = {}
    for k, v in raw.items():
        out[int(k)] = {}
        for k2, curve in v.items():
            curve = [np.asarray(c) if isinstance(c, list) else c
                     for c in curve]
            out[int(k)][int(k2)] = curve
    return out


def _curve_boundary_points(curve) -> np.ndarray:
    """Sample a trimmed curve ([..., range] format from pipeline.py)."""
    kind = curve[0]
    if kind == "line":
        k, d, rng = np.asarray(curve[1], float), np.asarray(curve[2], float), \
            curve[3]
        if not isinstance(rng, (list, np.ndarray)) or len(rng) < 2:
            return np.zeros((0, 3))
        t = np.linspace(float(rng[0]), float(rng[1]), 16)
        return d[None] + t[:, None] * k[None]
    if kind == "circle":
        c = np.asarray(curve[1], float)
        x = np.asarray(curve[2], float)
        y = np.asarray(curve[3], float)
        r = float(curve[4])
        rng = curve[5] if len(curve) > 5 else [0.0, TWO_PI]
        a = np.linspace(float(rng[0]), float(rng[1]), CIRCLE_V)
        return c[None] + r * (np.cos(a)[:, None] * x[None]
                              + np.sin(a)[:, None] * y[None])
    if kind == "ellipse":
        c = np.asarray(curve[1], float)
        x = np.asarray(curve[2], float)
        y = np.asarray(curve[3], float)
        rx, ry = float(curve[4]), float(curve[5])
        a = np.linspace(0, TWO_PI, CIRCLE_V)
        return c[None] + rx * np.cos(a)[:, None] * x[None] \
            + ry * np.sin(a)[:, None] * y[None]
    return np.zeros((0, 3))


def _plane_axes(n: np.ndarray):
    h = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0.0, 1, 0])
    x = np.cross(n, h)
    x /= np.linalg.norm(x) + 1e-12
    return x, np.cross(n, x)


# ---------------------------------------------------------------------------
# polygon machinery: loop walking + ear-clipping CDT with hole bridging
# (replaces the reference's get_polygon_set + `triangle` dependency,
# reference arg2mesh.py:237-332 + :107-111)
# ---------------------------------------------------------------------------

def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _walk_loops(segments, tol: float = 1e-3):
    """Chain 2-D segments [(p0, p1), ...] into closed loops by matching
    endpoints within tol (the reference's find_another_point walk,
    arg2mesh.py:242-331). Returns a list of (L_i, 2) uv loops; open chains
    are closed implicitly (reference behavior: the walk simply stops and the
    partial polygon is kept)."""
    pts: list = []          # canonical vertices
    adj: list = []          # adjacency lists of vertex indices

    def canon(p):
        for i, q in enumerate(pts):
            if abs(p[0] - q[0]) + abs(p[1] - q[1]) < tol:
                return i
        pts.append((float(p[0]), float(p[1])))
        adj.append([])
        return len(pts) - 1

    for p0, p1 in segments:
        a, b = canon(p0), canon(p1)
        if a == b:
            continue
        if b not in adj[a]:
            adj[a].append(b)
        if a not in adj[b]:
            adj[b].append(a)

    visited_edges = set()  # undirected: each boundary edge joins ONE loop

    def key(a, b):
        return (a, b) if a < b else (b, a)

    loops = []
    for start in range(len(pts)):
        for first in adj[start]:
            if key(start, first) in visited_edges:
                continue
            loop = [start]
            prev, cur = start, first
            visited_edges.add(key(start, first))
            while cur != start:
                loop.append(cur)
                nxt = None
                for cand in adj[cur]:
                    if cand != prev and key(cur, cand) not in visited_edges:
                        nxt = cand
                        break
                if nxt is None:
                    break  # dead end: keep the partial chain
                visited_edges.add(key(cur, nxt))
                prev, cur = cur, nxt
            if len(loop) >= 3:
                loops.append(np.asarray([pts[i] for i in loop], float))
    return loops


def _point_in_triangle(p, a, b, c, eps=1e-12) -> bool:
    d1 = (p[0] - b[0]) * (a[1] - b[1]) - (a[0] - b[0]) * (p[1] - b[1])
    d2 = (p[0] - c[0]) * (b[1] - c[1]) - (b[0] - c[0]) * (p[1] - c[1])
    d3 = (p[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (p[1] - a[1])
    has_neg = (d1 < -eps) or (d2 < -eps) or (d3 < -eps)
    has_pos = (d1 > eps) or (d2 > eps) or (d3 > eps)
    return not (has_neg and has_pos)


def _ear_clip(poly: np.ndarray):
    """Triangulate a simple CCW polygon (possibly with duplicate bridge
    vertices) by ear clipping. Returns index triples into poly."""
    n = poly.shape[0]
    idx = list(range(n))
    tris = []
    fail = 0
    while len(idx) > 3 and fail <= len(idx):
        m = len(idx)
        clipped = False
        for k in range(m):
            i0, i1, i2 = idx[(k - 1) % m], idx[k], idx[(k + 1) % m]
            a, b, c = poly[i0], poly[i1], poly[i2]
            cross = (b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0])
            if cross <= 1e-14:
                continue  # reflex or collinear corner
            ok = True
            for j in idx:
                if j in (i0, i1, i2):
                    continue
                p = poly[j]
                # skip points coincident with a corner (bridge duplicates)
                if (min(abs(p[0] - q[0]) + abs(p[1] - q[1])
                        for q in (a, b, c)) < 1e-12):
                    continue
                if _point_in_triangle(p, a, b, c):
                    ok = False
                    break
            if ok:
                tris.append((i0, i1, i2))
                idx.pop(k)
                clipped = True
                break
        if not clipped:
            # numerical dead end: clip the widest convex corner to guarantee
            # progress (degenerate inputs only)
            tris.append((idx[0], idx[1], idx[2]))
            idx.pop(1)
            fail += 1
    if len(idx) == 3:
        tris.append((idx[0], idx[1], idx[2]))
    return tris


def _bridge_hole(outer: np.ndarray, hole: np.ndarray) -> np.ndarray:
    """Connect a CW hole into a CCW outer polygon with a two-way bridge at
    a mutually visible vertex pair (Eberly's max-x ray method)."""
    m_i = int(np.argmax(hole[:, 0]))
    M = hole[m_i]
    n = outer.shape[0]
    best_t, best_edge, best_ix = np.inf, -1, None
    for j in range(n):
        p, q = outer[j], outer[(j + 1) % n]
        if (p[1] - M[1]) * (q[1] - M[1]) > 0:
            continue  # edge doesn't span the ray's y
        dy = q[1] - p[1]
        if abs(dy) < 1e-15:
            ix = max(p[0], q[0])
        else:
            t = (M[1] - p[1]) / dy
            if t < -1e-9 or t > 1 + 1e-9:
                continue
            ix = p[0] + t * (q[0] - p[0])
        if ix >= M[0] - 1e-9 and ix - M[0] < best_t:
            best_t, best_edge, best_ix = ix - M[0], j, ix
    if best_edge < 0:
        best_edge = int(np.argmin(np.abs(outer - M).sum(1)))
        vis = best_edge
    else:
        # visible vertex: the intersected edge's endpoint with larger x,
        # unless a reflex vertex hides it inside triangle (M, I, P)
        j = best_edge
        p, q = outer[j], outer[(j + 1) % n]
        vis = j if p[0] > q[0] else (j + 1) % n
        I = np.array([best_ix, M[1]])
        cand, cand_d = vis, None
        for k in range(n):
            r = outer[k]
            if k == vis or r[0] < M[0]:
                continue
            if _point_in_triangle(r, M, I, outer[vis]):
                d = abs(r[0] - M[0]) + abs(r[1] - M[1])
                if cand_d is None or d < cand_d:
                    cand, cand_d = k, d
        vis = cand
    # splice: outer[..vis], M..hole..M, outer[vis..]
    hole_seq = np.concatenate([hole[m_i:], hole[:m_i + 1]])  # M ... M
    return np.concatenate([outer[: vis + 1], hole_seq,
                           outer[vis: vis + 1], outer[vis + 1:]])


def triangulate_with_holes(outer: np.ndarray, holes):
    """CDT of a polygon with holes via bridging + ear clipping.
    outer: (N, 2) any orientation; holes: list of (M_i, 2).
    Returns (vertices (V, 2), faces [(i, j, k) 0-indexed])."""
    if _signed_area(outer) < 0:
        outer = outer[::-1]
    fixed = []
    for h in holes:
        if _signed_area(h) > 0:
            h = h[::-1]  # holes must wind CW
        fixed.append(h)
    # bridge right-most holes first so later bridges can't cross them
    fixed.sort(key=lambda h: -float(h[:, 0].max()))
    poly = outer
    for h in fixed:
        poly = _bridge_hole(poly, h)
    return poly, _ear_clip(poly)


def plane_mesh(par, curves: Dict[int, list]):
    """Plane face bounded by its trimmed curves: loops -> outer + holes ->
    ear-clipping CDT (reference: arg2mesh.py:30-118,237-332)."""
    n = np.asarray(par[1], float).reshape(3)
    n /= np.linalg.norm(n) + 1e-12
    d = float(par[2])
    x, y = _plane_axes(n)
    origin = n * d

    def to_uv(pts3):
        rel = pts3 - origin
        return np.stack([rel @ x, rel @ y], 1)

    # boundary segments: line edges as single chords, circles as chord
    # chains (reference converts circles to line edges, :83-95)
    segments = []
    for c in curves.values():
        pts = _curve_boundary_points(c)
        if pts.shape[0] < 2:
            continue
        uv = to_uv(pts)
        if c[0] == "line":
            segments.append((uv[0], uv[-1]))
        else:
            for j in range(uv.shape[0] - 1):
                segments.append((uv[j], uv[j + 1]))

    if not segments:
        # unbounded plane: default square patch
        s = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
        verts = origin[None] + s[:, :1] * x[None] + s[:, 1:] * y[None]
        return verts, [[1, 2, 3], [1, 3, 4]]

    loops = _walk_loops(segments)
    loops = [lp for lp in loops if abs(_signed_area(lp)) > 1e-10]
    if not loops:
        # boundary didn't close into any loop: angular-fan fallback
        pts = np.concatenate([np.stack(s) for s in segments])
        return _fan_fallback(pts, origin, x, y)

    areas = [abs(_signed_area(lp)) for lp in loops]
    outer = loops[int(np.argmax(areas))]
    max_area = max(areas)
    # smaller loops are holes (reference area criterion, :89-105)
    holes = [lp for lp, a in zip(loops, areas)
             if a < max_area - 1e-8 and lp is not outer]
    poly, tris = triangulate_with_holes(outer, holes)
    verts = origin[None] + poly[:, :1] * x[None] + poly[:, 1:] * y[None]
    faces = [[i + 1, j + 1, k + 1] for i, j, k in tris]
    return verts, faces


def _fan_fallback(pts3_uv_source, origin, x, y):
    uv = pts3_uv_source
    centroid = uv.mean(0)
    ang = np.arctan2(uv[:, 1] - centroid[1], uv[:, 0] - centroid[0])
    uv = uv[np.argsort(ang)]
    keep = [0]
    for i in range(1, uv.shape[0]):
        if np.abs(uv[i] - uv[keep[-1]]).sum() > 1e-4:
            keep.append(i)
    uv = uv[keep]
    verts3 = origin[None] + uv[:, :1] * x[None] + uv[:, 1:] * y[None]
    center3 = origin + centroid[0] * x + centroid[1] * y
    verts = np.concatenate([center3[None], verts3])
    m = uv.shape[0]
    faces = [[1, 2 + i, 2 + (i + 1) % m] for i in range(m)]
    return verts, faces


def _axial_range(axis, origin, curves, default=(-0.5, 0.5)):
    ts = []
    for c in curves.values():
        pts = _curve_boundary_points(c)
        if pts.shape[0]:
            ts.extend(((pts - origin) @ axis).tolist())
    if not ts:
        return default
    lo, hi = min(ts), max(ts)
    if hi - lo < 1e-4:
        lo, hi = lo - 0.25, hi + 0.25
    return lo, hi


def _grid_faces(nu: int, nv: int, wrap_u: bool):
    faces = []
    for i in range(nu - (0 if wrap_u else 1)):
        i2 = (i + 1) % nu
        for j in range(nv - 1):
            a = i * nv + j + 1
            b = i2 * nv + j + 1
            faces.append([a, b, b + 1, a + 1])
    return faces


def _angle_range(curves):
    """Intersected angular range of the bounding circle edges (reference:
    arg2mesh.py:140-151 — u_min = max of the circles' t0, u_max = min of
    t1). Returns (u_min, u_max, full_ring)."""
    u_min, u_max = 0.0, TWO_PI
    found = False
    for c in curves.values():
        if c[0] != "circle" or len(c) <= 5:
            continue
        rng = c[5]
        if not isinstance(rng, (list, np.ndarray)) or len(rng) < 2:
            continue
        found = True
        u_min = max(u_min, float(rng[0]))
        u_max = min(u_max, float(rng[1]))
    if not found or u_max - u_min <= 1e-6:
        return 0.0, TWO_PI, True
    full = abs((u_max - u_min) - TWO_PI) < 1e-3
    return u_min, u_max, full


def _circle_frame(curves):
    """In-plane axes of the first bounding circle, so angular ranges are
    measured in the SAME frame they were trimmed in (the reference copies
    circle1's axes onto circle2, arg2mesh.py:372)."""
    for c in curves.values():
        if c[0] == "circle":
            x = np.asarray(c[2], float).reshape(3)
            y = np.asarray(c[3], float).reshape(3)
            if np.linalg.norm(x) > 1e-9 and np.linalg.norm(y) > 1e-9:
                return x / np.linalg.norm(x), y / np.linalg.norm(y)
    return None


def cylinder_mesh(par, curves):
    """Lateral band clipped to the boundary circles' angular range
    (reference doubleCircleEdge_mesh, arg2mesh.py:120-146,369-403)."""
    a = np.asarray(par[1], float).reshape(3)
    a /= np.linalg.norm(a) + 1e-12
    c = np.asarray(par[2], float).reshape(3)
    r = float(par[3])
    lo, hi = _axial_range(a, c, curves)
    frame = _circle_frame(curves)
    x, y = frame if frame is not None else _plane_axes(a)
    u0, u1, full = _angle_range(curves)
    theta = np.linspace(u0, u1, CIRCLE_V, endpoint=not full)
    z = np.linspace(lo, hi, 12)
    verts = []
    for t in theta:
        ring_dir = np.cos(t) * x + np.sin(t) * y
        for zz in z:
            verts.append(c + r * ring_dir + zz * a)
    return np.asarray(verts), _grid_faces(CIRCLE_V, len(z), wrap_u=full)


def cone_mesh(par, curves):
    """Lateral cone surface clipped to angular + axial boundary ranges
    (reference: arg2mesh.py:148-200,369-403)."""
    apex = np.asarray(par[1], float).reshape(3)
    a = np.asarray(par[2], float).reshape(3)
    a /= np.linalg.norm(a) + 1e-12
    theta = float(par[3])
    lo, hi = _axial_range(a, apex, curves, default=(0.02, 0.8))
    # the v2 cone fit orients the axis from the body TOWARD the apex
    # (primitive_forward_v2.py:868: (apex - p0) . a >= 0), so boundary
    # curves land at negative axial offsets; mesh down whichever side the
    # curves actually lie on (the reference arg2mesh is sign-insensitive —
    # it works from ||circle_c - apex|| distances, arg2mesh.py:160-190)
    if abs(lo) > abs(hi):
        a = -a
        lo, hi = -hi, -lo
    lo = max(lo, 0.0)
    hi = max(hi, lo + 1e-3)
    frame = _circle_frame(curves)
    x, y = frame if frame is not None else _plane_axes(a)
    u0, u1, full = _angle_range(curves)
    phi = np.linspace(u0, u1, CIRCLE_V, endpoint=not full)
    t = np.linspace(lo, hi, 12)
    verts = []
    for p in phi:
        ring_dir = np.cos(p) * x + np.sin(p) * y
        for tt in t:
            verts.append(apex + tt * a + tt * np.tan(theta) * ring_dir)
    return np.asarray(verts), _grid_faces(CIRCLE_V, len(t), wrap_u=full)


def sphere_mesh(par, curves):
    c = np.asarray(par[1], float).reshape(3)
    r = float(par[2])
    nu, nv = 32, 17
    u = np.linspace(0, TWO_PI, nu, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, nv)
    verts = []
    for uu in u:
        for vv in v:
            verts.append(c + r * np.array([np.sin(vv) * np.cos(uu),
                                           np.sin(vv) * np.sin(uu),
                                           np.cos(vv)]))
    verts = np.asarray(verts)
    # clip to one side of a single circle cut, if present
    circles = [cv for cv in curves.values() if cv[0] == "circle"]
    if len(circles) == 1:
        cv = circles[0]
        n = np.cross(np.asarray(cv[2], float), np.asarray(cv[3], float))
        plane_pt = np.asarray(cv[1], float)
        side = (verts - plane_pt) @ n
        keep_side = 1.0 if (side > 0).sum() >= (side < 0).sum() else -1.0
        # (vertex-level clipping keeps the larger cap; faces filtered below)
        keep = side * keep_side >= -1e-6
    else:
        keep = np.ones(len(verts), bool)
    faces_all = _grid_faces(nu, nv, wrap_u=True)
    remap = -np.ones(len(verts), int)
    remap[keep] = np.arange(keep.sum())
    verts = verts[keep]
    faces = []
    for f in faces_all:
        idx = [remap[i - 1] for i in f]
        if all(i >= 0 for i in idx):
            faces.append([i + 1 for i in idx])
    return verts, faces


_BUILDERS = {"plane": plane_mesh, "cylinder": cylinder_mesh,
             "cone": cone_mesh, "sphere": sphere_mesh}


def arg2mesh(output_dir: str, param_path: str, inter_lines_path: str):
    """Build per-instance OBJs + combined OBJ (reference: arg2mesh.py:739-800).
    Returns {instance_id: (vertices, faces)}."""
    os.makedirs(output_dir, exist_ok=True)
    params = parse_param_file(param_path)
    inter = parse_inter_lines(inter_lines_path)

    all_v, all_f, all_c = [], [], []
    built = {}
    for key, par in params.items():
        builder = _BUILDERS.get(par[0])
        if builder is None:
            continue
        curves = inter.get(key, {})
        verts, faces = builder(par, curves)
        if verts.shape[0] == 0:
            continue
        built[key] = (verts, faces)
        color = COLORS_TYPE[key % len(COLORS_TYPE)] / 255.0
        colors = np.tile(color, (verts.shape[0], 1))
        save_obj(os.path.join(output_dir, f"{key}_{par[0]}.obj"),
                 verts, faces, colors)
        offset = len(all_v)
        all_v.extend(verts.tolist())
        all_c.extend(colors.tolist())
        all_f.extend([[i + offset for i in f] for f in faces])
    if all_v:
        save_obj(os.path.join(output_dir, "combined.obj"),
                 np.asarray(all_v), all_f, np.asarray(all_c))
    return built


def batch_arg2mesh(src_dir: str, out_root: str, shape_ids):
    """Batch driver (reference: arg2mesh/batch_main.py)."""
    for sid in shape_ids:
        param = os.path.join(src_dir, "paras", f"param_{sid}.txt")
        inter = os.path.join(src_dir, "paras", f"param_inter_lines_{sid}.json")
        if os.path.exists(param) and os.path.exists(inter):
            arg2mesh(os.path.join(out_root, str(sid)), param, inter)
