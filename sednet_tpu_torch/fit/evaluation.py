"""Residual evaluation: clustering, matching, fitting, residuals.

Counterpart of `sednet_tpu/fit/evaluation.py:39-243` (reference:
Fitting_patches_and_edges/residual_utils.py:49-331, src/eval_utils.py:103-175):

  * match: Hungarian assignment on the relaxed-IoU cost between predicted
    clusters and true segments (src/fitting_utils.py:362-376);
  * weights_normalize: mean-shift kernel membership -> probabilities
    (src/fitting_utils.py:306-325);
  * residual train mode: fit the matched true segments with soft weights;
  * residual eval mode: fit the predicted segments (majority predicted
    type) with unit weights, residuals against the matched true points
    (sqrt=True);
  * separate_losses: the spline / geometric split with the > 1 -> 0.1
    clamp of degenerate fits (src/eval_utils.py:130-175);
  * p_coverage: SPFN coverage at 0.01 (src/eval_utils.py:103-127).

Device work runs on the fitter's device; the assignment and the
bookkeeping stay on the host, as in JAX. `residual_eval_batch` marks its
three steps with spans (`STAGES`, `utils.tracing.span`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sednet_tpu_torch.cluster import guard_mean_shift
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.fit.driver import FittingModule, fit_one_shape
from sednet_tpu_torch.fit.residuals import (distance_from_cone,
                                            distance_from_cylinder,
                                            distance_from_plane,
                                            distance_from_sphere,
                                            residual_loss_batched)
from sednet_tpu_torch.metrics import (hungarian_match, relaxed_iou_fast,
                                      to_one_hot)
from sednet_tpu_torch.ops.chamfer import nn_distance
from sednet_tpu_torch.ops.guard import guard_exp
from sednet_tpu_torch.utils.tracing import span

EPS = 1e-8

# the spans of residual_eval_batch, in the order they run
STAGES = tuple(f"residual_eval_batch/{s}" for s in ("match", "fits",
                                                     "residuals"))


def _relaxed_costs(preds, targets, device) -> np.ndarray:
    """1 - relaxed IoU of each pair of (N,) label arrays, one call on the
    device: (B, 50, 50) numpy."""
    pred_oh = torch.from_numpy(np.stack([to_one_hot(np.asarray(p))
                                         for p in preds])).to(device)
    gt_oh = torch.from_numpy(np.stack([to_one_hot(np.asarray(t))
                                       for t in targets])).to(device)
    return 1.0 - relaxed_iou_fast(pred_oh, gt_oh).cpu().numpy()


def match(target: np.ndarray, pred_labels: np.ndarray, device=None):
    """Hungarian match on relaxed IoU (reference:
    src/fitting_utils.py:362-376). Returns (rows, cols, unique_target,
    unique_pred)."""
    cost = _relaxed_costs([pred_labels], [target], resolve_device(device))[0]
    rids, cids = hungarian_match(cost)
    return rids, cids, np.unique(target), np.unique(pred_labels)


def weights_normalize(weights, bw: float):
    """Mean-shift kernel membership (K, N) -> probabilities
    (reference: src/fitting_utils.py:306-325)."""
    prob = guard_exp(weights / (bw * bw) / 2.0)
    prob = prob / prob.sum(0, keepdim=True)
    if weights.shape[0] == 1:
        return prob
    prob = prob - prob.amin(1, keepdim=True)
    return prob / (prob.amax(1, keepdim=True) + EPS)


def separate_losses(distance: Dict, gt_points: Dict, lamb: float = 1.0):
    """Spline / geometric residual split (reference:
    src/eval_utils.py:130-175). Returns [mean loss, geometric mean or None,
    spline mean or None]."""
    losses, geom, spline = [], [], []
    for k in sorted(gt_points.keys()):
        if gt_points[k] is None or k not in distance:
            continue
        if gt_points[k].shape[0] < 100:
            continue
        name, d = distance[k]
        d = float(d)
        if d > 1:  # degenerate (reference: eval_utils.py:149-152)
            d = 0.1
        if name in ("closed-spline", "open-spline"):
            spline.append(d)
            losses.append(d * lamb)
        else:
            geom.append(d)
            losses.append(d)
    total = float(np.mean(losses)) if losses else 0.0
    return [total,
            float(np.mean(geom)) if geom else None,
            float(np.mean(spline)) if spline else None]


def p_coverage(points: np.ndarray, parameters: Dict, threshold: float = 0.01,
               device=None):
    """SPFN coverage: each point's least distance to any fitted primitive
    (reference: src/eval_utils.py:103-127), on `device` (None: the card).
    Returns (mean distance, share of points within threshold)."""
    pts = torch.as_tensor(np.asarray(points, np.float32),
                          device=resolve_device(device))
    kw = dict(weights=None, sqrt=True, reduce=False)
    dists = []
    for v in parameters.values():
        if v is None:
            continue
        name = v[0]
        if name == "plane":
            dists.append(distance_from_plane(pts, v[1], v[2], **kw))
        elif name == "sphere":
            dists.append(distance_from_sphere(pts, v[1], v[2], **kw))
        elif name == "cylinder":
            dists.append(distance_from_cylinder(pts, v[1], v[2], v[3], **kw))
        elif name == "cone":
            dists.append(distance_from_cone(pts, v[1], v[2], v[3], **kw))
        else:  # spline: one-sided nearest distance to the sampled surface
            surf = torch.as_tensor(v[1], dtype=torch.float32,
                                   device=pts.device)
            d1, _, _, _ = nn_distance(pts[None], surf[None])
            dists.append(torch.sqrt(torch.clamp(d1[0], min=1e-12)))
    if not dists:
        return float("nan"), 0.0
    reduce_distance = torch.stack(dists, 0).amin(0)
    cover = float((reduce_distance < threshold).float().mean())
    return float(reduce_distance.mean()), cover


class Evaluation:
    """End-to-end residual evaluation (reference: residual_utils.py:49-152)
    on the fitter's device."""

    def __init__(self, fitter: FittingModule | None = None):
        self.fitter = fitter or FittingModule()

    @property
    def device(self):
        return self.fitter.device

    def cluster(self, embedding, generator=None, sel=None, quantile=0.015,
                iterations=50):
        """Guarded mean-shift of the unit rows of embedding (N, E); the
        generator (or the subsample sel) takes the place of JAX's key.
        Returns (result, unit embedding)."""
        emb = embedding / torch.clamp(
            torch.linalg.vector_norm(embedding, dim=-1, keepdim=True),
            min=1e-12)
        res = guard_mean_shift(emb, num_samples=min(10000, emb.shape[0]),
                               quantile=quantile, iterations=iterations,
                               max_clusters=49, retry_factor=1.2,
                               generator=generator, sel=sel)
        return res, emb

    def _eval_segments(self, si, it, cost):
        """The matched predicted segments of one shape and their true
        points, keyed by si(cluster id)."""
        labels = np.asarray(it["labels"])
        cluster_ids = np.asarray(it["cluster_ids"])
        pred_primitives = np.asarray(it["pred_primitives"])
        points = np.asarray(it["points"], np.float32)
        normals = np.asarray(it["normals"], np.float32)
        rows, cols = hungarian_match(cost)
        col_of = dict(zip(rows, cols))
        segments, gt_points = [], {}
        for i in np.sort(np.unique(cluster_ids)):
            c = col_of.get(i)
            if c is None:
                continue
            gt_i = labels == c
            pred_i = cluster_ids == i
            if gt_i.sum() == 0 or pred_i.sum() == 0:
                continue
            vals, counts = np.unique(pred_primitives[pred_i],
                                     return_counts=True)
            segments.append({
                "id": si(int(i)), "label": int(vals[np.argmax(counts)]),
                "points": points[pred_i], "normals": normals[pred_i],
                "weights": np.ones(int(pred_i.sum()), np.float32),
            })
            gt_points[si(int(i))] = points[gt_i]
        return segments, gt_points

    def residual_eval_mode(self, points, normals, labels, cluster_ids,
                           pred_primitives, *, if_optimize=False, lamb=1.0):
        """Fit the predicted segments (majority predicted type), residuals
        against the matched true points (reference:
        residual_utils.py:210-331). Returns (loss, parameters, distance)."""
        return self.residual_eval_batch(
            [{"points": points, "normals": normals, "labels": labels,
              "cluster_ids": cluster_ids,
              "pred_primitives": pred_primitives}],
            if_optimize=if_optimize, lamb=lamb)[0]

    def residual_eval_batch(self, items, *, if_optimize=False, lamb=1.0):
        """`residual_eval_mode` over many shapes: one relaxed-IoU call on the
        device matches every shape, then all shapes' segments go through
        the same packed fit and residual calls. items: dicts with points,
        normals, labels, cluster_ids, pred_primitives. Returns a list of
        (loss, parameters, distance)."""
        if not items:
            return []
        with span(STAGES[0]):
            costs = _relaxed_costs([it["cluster_ids"] for it in items],
                                   [it["labels"] for it in items],
                                   self.device)
            segments, gt_points = [], {}
            for si, it in enumerate(items):
                seg, gp = self._eval_segments(lambda i, s=si: (s, i), it,
                                              costs[si])
                segments += seg
                gt_points.update(gp)
        with span(STAGES[1]):
            parameters, _ = fit_one_shape(segments, self.fitter,
                                          eval_mode=True,
                                          if_optimize=if_optimize)
        with span(STAGES[2]):
            distance = residual_loss_batched(gt_points, parameters,
                                             sqrt=True, device=self.device)
        out = []
        for si in range(len(items)):
            gp = {k[1]: v for k, v in gt_points.items() if k[0] == si}
            par = {k[1]: v for k, v in parameters.items() if k[0] == si}
            dist = {k[1]: v for k, v in distance.items() if k[0] == si}
            out.append((separate_losses(dist, gp, lamb=lamb), par, dist))
        return out

    def residual_train_mode(self, points, normals, labels, cluster_ids,
                            primitives, weights, bw, *, lamb=1.0):
        """Fit the true segments matched to each predicted cluster with soft
        mean-shift weights (reference: residual_utils.py:154-209). weights:
        (K, N) centre-point similarities, a tensor on the device. Returns
        (loss, parameters, distance)."""
        rows, cols, _, unique_pred = match(labels, cluster_ids, self.device)
        col_of = dict(zip(rows, cols))
        w = weights_normalize(weights, float(bw)).T.cpu().numpy()  # (N, K)
        # training subsamples every other point (primitive_forward.py:946-951)
        sub = np.arange(0, points.shape[0], 2)
        segments, gt_points = [], {}
        for i in np.sort(unique_pred):
            c = col_of.get(i)
            if c is None:
                continue
            gt_i = labels == c
            if gt_i.sum() == 0 or (cluster_ids == i).sum() == 0:
                continue
            vals, counts = np.unique(primitives[gt_i], return_counts=True)
            segments.append({
                "id": int(i), "label": int(vals[np.argmax(counts)]),
                "points": points[sub], "normals": normals[sub],
                "weights": w[sub, i],
            })
            gt_points[int(i)] = np.asarray(points[gt_i], np.float32)
        parameters, _ = fit_one_shape(segments, self.fitter, eval_mode=False)
        distance = residual_loss_batched(gt_points, parameters,
                                         device=self.device)
        return separate_losses(distance, gt_points, lamb=lamb), parameters, \
            distance
