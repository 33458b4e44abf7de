"""Patch -> edges -> corners post-processing pipeline (one shape).

A numpy copy of `sednet_tpu/postproc/pipeline.py`; the same arithmetic in the
same order, so that both packages write the same files.

Rebuild of reference Fitting_patches_and_edges/primitive_forward_v2.py
__main__ (:1074-1621) as a callable, minus the per-shape-id manual label
overrides (:1135-1160 hardcode fixes for ids 452/722/925/...; we keep only
the principled priors). Steps:

  1. majority-vote instance types with spline-vs-quadric priors (:1118-1133);
  2. exclude instance-boundary points before cylinder/cone fits (:1162-1168);
  3. robust v2 fits per instance (my_fit_one_shape, :935-1051);
  4. drop high-residual points, build the face adjacency map (:1196-1205);
  5. pairwise intersection curves for adjacent fitted faces (:1216-1396);
  6. corners: line x line and line x circle among each instance's curves,
     kept only when near all three instances' points (:1400-1539);
  7. trim each edge between its corners -> final edges (:1545-1593);
  8. dumps: param_{id}.txt, param_inter_lines_{id}.json,
     {id}_edges/corners/final_edges.txt (:1178-1621).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from sednet_tpu_torch.postproc.boundary import (bad_points_mask, boundary_edge_mask,
                                          face_adjacency)
from sednet_tpu_torch.postproc.intersections import (intersect,
                                               line_circle_intersection,
                                               line_line_intersection)
from sednet_tpu_torch.postproc.robust_fits import RobustFitter

# compacted fitting-stage type ids (data.labels.project_types_fitting)
T_CLOSED, T_PLANE, T_CYLINDER, T_CONE, T_SPHERE, T_OPEN = 0, 1, 2, 3, 4, 5


def majority_type_with_priors(types_in_inst: np.ndarray) -> int:
    """Majority type with the reference's quadric-over-spline priors
    (primitive_forward_v2.py:1122-1133): a spline vote flips to cone/cylinder
    if they hold >25% of the points, or to plane if it holds >10%."""
    count = np.bincount(types_in_inst, minlength=6)
    label = int(np.argmax(count))
    if label in (T_CLOSED, T_OPEN):
        total = count.sum()
        order = np.argsort(count)[::-1]
        if order.shape[0] > 1:
            runner = int(order[1])
            if runner in (T_CYLINDER, T_CONE) and count[runner] / total > 0.25:
                return runner
            if runner == T_PLANE and count[runner] / total > 0.1:
                return runner
    return label


def _near_all(point: np.ndarray, point_sets, thresh: float) -> bool:
    """fitter_point: corner must lie near every involved instance's points
    (reference: proj_2_edge_utils.py:480-489)."""
    for pts in point_sets:
        if pts.shape[0] == 0:
            return False
        d = np.sqrt(((pts - point[None]) ** 2).sum(1)).min()
        if d > thresh:
            return False
    return True


def _sample_curve(curve, t_range=None, step=0.01):
    kind = curve[0]
    if kind == "line":
        k, d = np.asarray(curve[1]), np.asarray(curve[2])
        lo, hi = (-0.5, 0.5) if t_range is None else (min(t_range),
                                                      max(t_range))
        t = np.arange(lo, hi, 0.002 if t_range is not None else 0.001)
        return d[None] + t[:, None] * k[None]
    if kind == "circle":
        c, x, y, r = (np.asarray(curve[1]), np.asarray(curve[2]),
                      np.asarray(curve[3]), float(curve[4]))
        lo, hi = (0, 2 * np.pi) if t_range is None else (min(t_range),
                                                         max(t_range))
        a = np.arange(lo, hi, step)[:, None]
        return c[None] + r * (np.cos(a) * x[None] + np.sin(a) * y[None])
    if kind == "ellipse":
        c, x, y, rx, ry = (np.asarray(curve[1]), np.asarray(curve[2]),
                           np.asarray(curve[3]), float(curve[4]),
                           float(curve[5]))
        a = np.arange(0, 2 * np.pi, step)[:, None]
        return c[None] + rx * np.cos(a) * x[None] + ry * np.sin(a) * y[None]
    return np.zeros((0, 3))


def _line_t(k, d, point):
    """Parameter of the projection of `point` onto line (k, d)
    (reference: get_line_point_d)."""
    k = np.asarray(k, float)
    return float(np.dot(np.asarray(point) - np.asarray(d), k)
                 / (np.dot(k, k) + 1e-12))


def _circle_angles(c1, c2, center, x_axis, y_axis):
    """Angles of two corners on a circle (reference:
    get_circle_two_point_theta) — returns sorted (a1, a2)."""
    def ang(p):
        v = np.asarray(p) - np.asarray(center)
        return float(np.arctan2(np.dot(v, y_axis), np.dot(v, x_axis))
                     % (2 * np.pi))

    a1, a2 = sorted((ang(c1), ang(c2)))
    return a1, a2


def process_shape(points: np.ndarray, normals: np.ndarray, insts: np.ndarray,
                  types: np.ndarray, *, min_points: int = 40,
                  corner_dist_thresh: float = 0.01, nn_num_thresh: int = 2,
                  filter_bad_points: bool = True,
                  plane_sample_ratio: float = 0.5,
                  spline_fitter=None) -> Dict:
    """Full post-processing of one shape. types must already be compacted via
    project_types_fitting. Returns a dict with parameters, curves, corners,
    edges, final_edges, adjacency."""
    fitter = RobustFitter(plane_filter_ratio=plane_sample_ratio)
    primitive_ids = np.unique(insts)
    strict_edge = boundary_edge_mask(points, insts, strict=True)

    # 1-3: per-instance robust fits
    parameters: Dict[int, tuple] = {}
    inst_points: Dict[int, np.ndarray] = {}
    for pid in primitive_ids:
        pid = int(pid)
        mask = insts == pid
        label = majority_type_with_priors(types[mask])
        if label in (T_CYLINDER, T_CONE):
            mask = mask & ~strict_edge
        p, n = points[mask, :3], normals[mask]
        # the corner proximity filter later measures distance to THESE
        # sets — i.e. boundary-excluded for cylinder/cone instances,
        # exactly like the reference's inst_data
        # (primitive_forward_v2.py:1158-1171 builds inst_data from the
        # edge-filtered index; the fitter_point test at :1431 reads it)
        inst_points[pid] = p
        if p.shape[0] < min_points:
            parameters[pid] = None
            continue
        if label == T_PLANE:
            parameters[pid] = fitter.fit_plane(p, n)
        elif label == T_CYLINDER:
            parameters[pid] = fitter.fit_cylinder(p, n)
        elif label == T_CONE:
            parameters[pid] = fitter.fit_cone(p, n)
        elif label == T_SPHERE:
            parameters[pid] = fitter.fit_sphere(p, n)
        elif spline_fitter is not None:
            parameters[pid] = spline_fitter(p, n, closed=(label == T_CLOSED))
        else:
            parameters[pid] = None

    # 4: adjacency (optionally after dropping high-residual points)
    id_to_index = {int(pid): i for i, pid in enumerate(primitive_ids)}
    par_by_index = {i: parameters[int(pid)]
                    for i, pid in enumerate(primitive_ids)}
    if filter_bad_points:
        bad = bad_points_mask(points[:, :3], insts, primitive_ids,
                              par_by_index)
        keep = ~bad
        adjacency = face_adjacency(points[keep], insts[keep], primitive_ids,
                                   nn_num_thresh)
    else:
        adjacency = face_adjacency(points, insts, primitive_ids,
                                   nn_num_thresh)

    # 5: pairwise intersection curves
    curves: Dict[int, Dict[int, tuple]] = {int(p): {} for p in primitive_ids}
    edges = []
    for i1 in primitive_ids:
        i1 = int(i1)
        if parameters[i1] is None:
            continue
        for i2 in np.nonzero(adjacency[i1])[0]:
            i2 = int(i2)
            if i2 not in curves or parameters.get(i2) is None:
                continue
            if i1 in curves[i2] or i2 in curves[i1]:
                continue
            pref = inst_points[i1][0] if inst_points[i1].shape[0] else None
            curve = intersect(parameters[i1], parameters[i2],
                              preferred_point=pref)
            if curve[0] is None:
                adjacency[i1, i2] = adjacency[i2, i1] = False
                continue
            if curve[0] == "two-line":
                curve = ("line", curve[1], curve[2])
            curves[i1][i2] = curve
            curves[i2][i1] = curve
            edges.append(_sample_curve(curve))
    edges = np.concatenate(edges, 0) if edges else np.zeros((0, 3))

    # 6: corners
    corners = []
    corner_ranges: Dict[int, Dict[int, List[np.ndarray]]] = {
        int(p): {} for p in primitive_ids}

    def add_corner(inst_a, inst_b, point):
        lst = corner_ranges[inst_a].setdefault(inst_b, [])
        for c in lst:
            if np.linalg.norm(c - point) < 1e-2:
                return
        lst.append(point)
        corner_ranges[inst_b].setdefault(inst_a, [])
        if all(np.linalg.norm(c - point) >= 1e-2
               for c in corner_ranges[inst_b][inst_a]):
            corner_ranges[inst_b][inst_a].append(point)

    for inst in primitive_ids:
        inst = int(inst)
        neibs = sorted(curves[inst].keys())
        if len(neibs) < 3:
            continue
        for mi in range(len(neibs) - 1):
            for ni in range(mi + 1, len(neibs)):
                m, n = neibs[mi], neibs[ni]
                cm, cn = curves[inst][m], curves[inst][n]
                pts3 = (inst_points[inst], inst_points[m], inst_points[n])
                found = []
                if cm[0] == cn[0] == "line":
                    p = line_line_intersection(cm[1], cm[2], cn[1], cn[2])
                    if p is not None:
                        found = [p]
                elif cm[0] == "line" and cn[0] == "circle":
                    r = line_circle_intersection(cm[1:], cn[1:])
                    found = list(r) if r else []
                elif cm[0] == "circle" and cn[0] == "line":
                    r = line_circle_intersection(cn[1:], cm[1:])
                    found = list(r) if r else []
                for p in found:
                    if _near_all(p, pts3, corner_dist_thresh):
                        corners.append(p)
                        add_corner(inst, m, p)
                        add_corner(inst, n, p)
    corners = np.stack(corners) if corners else np.zeros((0, 3))

    # 7: trim edges between corners
    final_edges = []
    trimmed: Dict[int, Dict[int, list]] = {int(p): {} for p in primitive_ids}
    for i1 in primitive_ids:
        i1 = int(i1)
        for i2, curve in curves[i1].items():
            if i2 < i1:
                continue
            cs = corner_ranges[i1].get(i2, [])
            if curve[0] == "line":
                if len(cs) >= 2:
                    ts = sorted(_line_t(curve[1], curve[2], c) for c in cs)
                    rng = [ts[0], ts[-1]]
                    final_edges.append(_sample_curve(curve, t_range=rng))
                else:
                    rng = []
                trimmed[i1][i2] = list(curve) + [rng]
            elif curve[0] == "circle":
                if len(cs) >= 2:
                    a1, a2 = _circle_angles(cs[0], cs[1], curve[1], curve[2],
                                            curve[3])
                    rng = [a1, a2]
                else:
                    rng = [0.0, 2 * np.pi]
                final_edges.append(_sample_curve(curve, t_range=rng))
                trimmed[i1][i2] = list(curve) + [rng]
            else:
                final_edges.append(_sample_curve(curve))
                trimmed[i1][i2] = list(curve) + [[0.0, 2 * np.pi]]
            trimmed.setdefault(i2, {})[i1] = trimmed[i1][i2]
    final_edges = (np.concatenate(final_edges, 0) if final_edges
                   else np.zeros((0, 3)))

    return {
        "parameters": parameters,
        "curves": trimmed,
        "corners": corners,
        "edges": edges,
        "final_edges": final_edges,
        "adjacency": adjacency,
        "primitive_ids": primitive_ids,
    }


def save_shape_parameters(out_dir: str, shape_id, result: Dict):
    """Write the reference's output vocabulary (param_{id}.txt,
    param_inter_lines_{id}.json, edges/corners/final_edges txt)
    (reference: primitive_forward_v2.py:1178-1621)."""
    os.makedirs(out_dir, exist_ok=True)
    paras_dir = os.path.join(out_dir, "paras")
    os.makedirs(paras_dir, exist_ok=True)

    with open(os.path.join(paras_dir, f"param_{shape_id}.txt"), "w") as f:
        for key, par in result["parameters"].items():
            if par is None:
                continue
            if par[0] in ("open-spline", "closed-spline"):
                # spline surfaces go to their own txt (the reference dumps
                # them separately too, primitive_forward_v2.py:1221-1223;
                # flattening 900+ points into the param line truncates)
                suffix = "_close_spline" if par[0] == "closed-spline" else ""
                np.savetxt(os.path.join(
                    out_dir, f"{shape_id}_{key}{suffix}.txt"),
                    np.asarray(par[1]), fmt="%0.4f", delimiter=";")
                f.write(f"id {key}: {par[0]} , \n")
                continue
            s = f"id {key}: "
            for item in par:
                if isinstance(item, np.ndarray):
                    item = np.array2string(item.flatten(), threshold=10000,
                                           max_line_width=10 ** 9)
                s += str(item) + " , "
            f.write(s + "\n")

    serializable = {}
    for k, v in result["curves"].items():
        serializable[int(k)] = {}
        for k2, curve in v.items():
            serializable[int(k)][int(k2)] = [
                c.tolist() if isinstance(c, np.ndarray) else c for c in curve]
    with open(os.path.join(paras_dir,
                           f"param_inter_lines_{shape_id}.json"), "w") as f:
        json.dump(serializable, f)

    np.savetxt(os.path.join(out_dir, f"{shape_id}_edges.txt"),
               result["edges"], fmt="%0.5f", delimiter=";")
    np.savetxt(os.path.join(out_dir, f"{shape_id}_corners.txt"),
               result["corners"], fmt="%0.5f", delimiter=";")
    np.savetxt(os.path.join(out_dir, f"{shape_id}_final_edges.txt"),
               result["final_edges"], fmt="%0.5f", delimiter=";")
