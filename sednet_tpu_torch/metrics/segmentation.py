"""Hungarian-matched segmentation and type IoU, in numpy on the host.

Counterpart of `sednet_tpu/metrics/segmentation.py:24-226` (reference:
src/segment_utils.py:140-188) without the chamfer variants. The relaxed-IoU
cost is computed in float32 over 50 one-hot columns, as the JAX package
does, and the assignment is scipy's.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

N_SEG = 50


def to_one_hot(target: np.ndarray, maxx: int = 50) -> np.ndarray:
    """(N,) int -> (N, maxx) float32 one-hot."""
    out = np.zeros((target.shape[0], maxx), np.float32)
    out[np.arange(target.shape[0]), target.astype(np.int64)] = 1.0
    return out


def relaxed_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Soft IoU of one-hot segmentations (N, K) and (N, K') -> (K, K')."""
    dots = pred.T @ gt
    norms_p = pred.sum(0)[:, None]
    norms_g = gt.sum(0)[None, :]
    return dots / (norms_p + norms_g - dots + np.float32(1e-7))


def relaxed_cost_from_labels(pred: np.ndarray, target: np.ndarray):
    """(N,) predicted and true ids -> (50, 50) float32 1 - relaxed IoU.
    Ids of 50 and above contribute no membership."""
    k = np.arange(N_SEG)
    ph = (pred[:, None] == k).astype(np.float32)
    gh = (target[:, None] == k).astype(np.float32)
    return np.float32(1.0) - relaxed_iou(ph, gh)


def _remap_eval(t: np.ndarray) -> np.ndarray:
    out = t.copy()
    out[(out == 0) | (out == 6) | (out == 7)] = 9
    out[out == 8] = 2
    return out


def primitive_type_per_segment(prim_one_hot: np.ndarray,
                               weights: np.ndarray) -> np.ndarray:
    """Majority type per predicted segment: (N, T), (N, K) -> (K,)."""
    return (prim_one_hot.T @ weights).argmax(0)


def siou_matched_segments(target, pred_labels, primitives_pred, primitives,
                          weights, min_gt_points: int = 100):
    """Matched segment IoU and type accuracy of one shape.

    target/pred_labels: (N,) instance ids; primitives_pred/primitives: (N,)
    type ids before the remap; weights: (N, K) predicted one-hot.
    Returns (seg_iou, type_iou, (rows, cols), prim_pairs, seg_recall)."""
    target = np.asarray(target)
    pred_labels = np.asarray(pred_labels)
    primitives = _remap_eval(np.asarray(primitives))
    prim_per_seg = primitive_type_per_segment(
        to_one_hot(_remap_eval(np.asarray(primitives_pred)), 10),
        np.asarray(weights, np.float32))
    rows, cols = linear_sum_assignment(
        relaxed_cost_from_labels(pred_labels, target))
    iou_b, prim_ok, prim_pairs, recall_b = [], [], [], []
    for r, c in zip(rows, cols):
        pred_i = pred_labels == r
        gt_i = target == c
        if gt_i.sum() < max(min_gt_points, 1) or pred_i.sum() == 0:
            continue
        tp = np.logical_and(pred_i, gt_i).sum()
        iou_b.append(tp / (np.logical_or(pred_i, gt_i).sum() + 1e-8))
        fn = np.logical_and(~pred_i, gt_i).sum()
        recall_b.append(tp / (tp + fn + 1e-8))
        gt_type = primitives[gt_i][0]
        pred_type = prim_per_seg[r]
        prim_ok.append(gt_type == pred_type)
        prim_pairs.append([gt_type, pred_type])

    def mean(v):
        return float(np.mean(v)) if v else float("nan")

    return (mean(iou_b), mean(prim_ok), (rows, cols), prim_pairs,
            mean(recall_b))


def batch_iou(shapes, labels, types):
    """Mean matched (inst IoU, type IoU) over a batch, as `bench.py`'s
    `batch_metrics`: shapes carry "labels" and "prim"; labels and types
    are (B, N) integer arrays. Returns (mean inst, mean type, per-shape
    list of (inst, type))."""
    per = []
    for i, s in enumerate(shapes):
        lab = np.asarray(labels[i]).astype(np.int64)
        w = to_one_hot(lab, max(int(lab.max()) + 1, 1))
        s_iou, p_iou, _, _, _ = siou_matched_segments(
            s["labels"].astype(np.int64), lab,
            np.asarray(types[i]).astype(np.int64),
            s["prim"].astype(np.int64), w)
        per.append((s_iou, p_iou))
    return (float(np.mean([p[0] for p in per])),
            float(np.mean([p[1] for p in per])), per)
