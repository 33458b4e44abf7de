"""Hungarian-matched segmentation and type IoU.

Counterpart of `sednet_tpu/metrics/segmentation.py:24-347` (reference:
src/segment_utils.py:124-355), with the chamfer-recall ("usecd") variant of
the reference-default eval, and the two per-sample metrics
`mean_iou_one_sample` and `compute_type_miou_abc`. The relaxed-IoU cost is computed in float32
over 50 one-hot columns, as the JAX package does (its counts are integers,
so the cost is the same bits on any device); the assignment is scipy's on
the host; the chamfer distances of the matched pairs run in PyTorch on the
device the caller names.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from sednet_tpu_torch.ops.chamfer import nn_distance

N_SEG = 50


def to_one_hot(target: np.ndarray, maxx: int = 50) -> np.ndarray:
    """(N,) int -> (N, maxx) float32 one-hot."""
    out = np.zeros((target.shape[0], maxx), np.float32)
    out[np.arange(target.shape[0]), target.astype(np.int64)] = 1.0
    return out


def _remap_eval(t: np.ndarray) -> np.ndarray:
    out = t.copy()
    out[(out == 0) | (out == 6) | (out == 7)] = 9
    out[out == 8] = 2
    return out


def primitive_type_per_segment(prim_one_hot: np.ndarray,
                               weights: np.ndarray) -> np.ndarray:
    """Majority type per predicted segment: (N, T), (N, K) -> (K,)."""
    return (prim_one_hot.T @ weights).argmax(0)


def _cost_one(pred_labels: np.ndarray, target: np.ndarray) -> np.ndarray:
    return _relaxed_cost_from_labels(
        torch.from_numpy(pred_labels.astype(np.int64))[None],
        torch.from_numpy(target.astype(np.int64))[None])[0].numpy()


def siou_matched_segments(target, pred_labels, primitives_pred, primitives,
                          weights, min_gt_points: int = 100):
    """Matched segment IoU and type accuracy of one shape.

    target/pred_labels: (N,) instance ids; primitives_pred/primitives: (N,)
    type ids before the remap; weights: (N, K) predicted one-hot.
    Returns (seg_iou, type_iou, (rows, cols), prim_pairs, seg_recall)."""
    target = np.asarray(target)
    pred_labels = np.asarray(pred_labels)
    prim_per_seg = primitive_type_per_segment(
        to_one_hot(_remap_eval(np.asarray(primitives_pred)), 10),
        np.asarray(weights, np.float32))
    return _collect_matched(target, pred_labels, prim_per_seg,
                            _remap_eval(np.asarray(primitives)),
                            _cost_one(pred_labels, target),
                            min_gt_points=min_gt_points)[:5]


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


def relaxed_iou_fast(pred, gt):
    """Soft IoU between one-hot segmentations, pred (B, N, K) and gt
    (B, N, K') tensors -> (B, K, K') (reference:
    src/segment_utils.py:609-627; `sednet_tpu/metrics/segmentation.py:32`)."""
    dots = torch.einsum("bnk,bnl->bkl", pred, gt)
    norms_p = pred.sum(1)[:, :, None]
    norms_g = gt.sum(1)[:, None, :]
    return dots / (norms_p + norms_g - dots + 1e-7)


def _relaxed_cost_from_labels(preds, targets):
    """(B, N) integer predicted and true ids (tensors) -> (B, 50, 50)
    float32 1 - relaxed IoU, the one-hots built on the ids' device. Ids of
    50 and above contribute no membership."""
    k = torch.arange(N_SEG, device=preds.device)
    ph = (preds[..., None] == k).float()
    gh = (targets.to(preds.device)[..., None] == k).float()
    return 1.0 - relaxed_iou_fast(ph, gh)


def hungarian_match(cost: np.ndarray):
    """rows, cols minimising the total cost (the reference uses
    lapsolver.solve_dense, src/segment_utils.py:173-176)."""
    return linear_sum_assignment(cost)


def _prim_type_per_segment_np(pred_labels: np.ndarray,
                              prims_pred: np.ndarray, n_seg: int = 50,
                              n_type: int = 10) -> np.ndarray:
    """Majority type per predicted segment by counts[k, t] = |{i: label_i
    == k and prim_i == t}|, argmax over t (first on ties, as the one-hot
    product's argmax)."""
    counts = np.bincount(
        pred_labels.astype(np.int64) * n_type + prims_pred.astype(np.int64),
        minlength=n_seg * n_type).reshape(n_seg, n_type)
    return counts.argmax(1)


def _collect_matched(target, pred_labels, prim_pred_per_seg, primitives,
                     cost, points=None, min_gt_points: int = 100,
                     use_chamfer: bool = False):
    """Hungarian matching and the matched-pair loop on a precomputed cost.
    With use_chamfer every matched pair counts (small segments too) and the
    pairs' point sets are handed back for one batched chamfer. Returns
    (seg_iou, type_iou, (rows, cols), prim_pairs, recall, cd_pairs)."""
    rows, cols = hungarian_match(cost)
    iou_b, prim_ok, prim_pairs, recall_b, cd_pairs = [], [], [], [], []
    for r, c in zip(rows, cols):
        pred_i = pred_labels == r
        gt_i = target == c
        if gt_i.sum() == 0 or pred_i.sum() == 0:
            continue
        if not use_chamfer and gt_i.sum() < min_gt_points:
            continue
        tp = np.logical_and(pred_i, gt_i).sum()
        iou_b.append(tp / (np.logical_or(pred_i, gt_i).sum() + 1e-8))
        if use_chamfer:
            cd_pairs.append((points[pred_i], points[gt_i]))
        else:
            fn = np.logical_and(~pred_i, gt_i).sum()
            recall_b.append(tp / (tp + fn + 1e-8))
        gt_type = primitives[gt_i][0]
        prim_ok.append(gt_type == prim_pred_per_seg[r])
        prim_pairs.append([gt_type, prim_pred_per_seg[r]])

    def mean(v):
        return float(np.mean(v)) if v else float("nan")

    return (mean(iou_b), mean(prim_ok), (rows, cols), prim_pairs,
            mean(recall_b), cd_pairs)


def _pow2(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _masked_chamfer_pairs(pairs, device="cpu") -> np.ndarray:
    """Symmetric chamfer of each (a (Na, 3), b (Nb, 3)) numpy pair, padded
    into buckets of power-of-two sizes: pads sit at 1e6 so they never win
    a nearest neighbour, and each direction's mean is weighted by the mask
    (so each pair's value is its own chamfer distance)."""
    groups: dict = {}
    for i, (x, y) in enumerate(pairs):
        groups.setdefault((_pow2(x.shape[0]), _pow2(y.shape[0])),
                          []).append(i)
    out = np.zeros((len(pairs),), np.float32)
    for (pa, pb), idxs in groups.items():
        sp = _pow2(len(idxs), lo=8)
        a = np.zeros((sp, pa, 3), np.float32)
        ma = np.zeros((sp, pa), np.float32)
        b = np.zeros((sp, pb, 3), np.float32)
        mb = np.zeros((sp, pb), np.float32)
        for j, i in enumerate(idxs):
            x, y = pairs[i]
            a[j, :x.shape[0]], ma[j, :x.shape[0]] = x, 1.0
            b[j, :y.shape[0]], mb[j, :y.shape[0]] = y, 1.0
        a, ma, b, mb = (torch.from_numpy(v).to(device) for v in (a, ma, b, mb))
        d1, d2, _, _ = nn_distance(a + (1.0 - ma[..., None]) * 1e6,
                                   b + (1.0 - mb[..., None]) * 1e6)
        m1 = (d1 * ma).sum(1) / torch.clamp_min(ma.sum(1), 1e-8)
        m2 = (d2 * mb).sum(1) / torch.clamp_min(mb.sum(1), 1e-8)
        out[np.asarray(idxs)] = (0.5 * (m1 + m2)).cpu().numpy()[:len(idxs)]
    return out


def siou_matched_segments_usecd(target, pred_labels, primitives_pred,
                                primitives, weights, points):
    """Chamfer-recall variant of the matched metrics for one shape; keeps
    small segments (reference: src/segment_utils.py:194-242). weights:
    (N, K) predicted one-hot; points (N, 3). Returns (seg_iou, type_iou,
    matching, prim_pairs, recall), recall = the share of true segments
    whose matched prediction lies within chamfer 0.1 (halved)."""
    target = np.asarray(target)
    pred_labels = np.asarray(pred_labels)
    prim_per_seg = primitive_type_per_segment(
        to_one_hot(_remap_eval(np.asarray(primitives_pred)), 10),
        np.asarray(weights, np.float32))
    seg_iou, prim_iou, matching, pairs, _, cd_pairs = _collect_matched(
        target, pred_labels, prim_per_seg,
        _remap_eval(np.asarray(primitives)), _cost_one(pred_labels, target),
        points=np.asarray(points), use_chamfer=True)
    recall_pos = 0
    if cd_pairs:
        recall_pos = int((_masked_chamfer_pairs(cd_pairs) / 2.0 < 0.1).sum())
    return (seg_iou, prim_iou, matching, pairs,
            recall_pos / np.unique(target).shape[0])


def siou_matched_segments_usecd_batch(targets, pred_labels, primitives_pred,
                                      primitives, points, device="cpu"):
    """siou_matched_segments_usecd for a batch of shapes, with one cost
    computation and one padded chamfer over every matched pair of every
    shape. targets / pred_labels / primitives_pred / primitives: sequences
    of (N,) integer arrays; points: (N, 3) arrays. Returns one (seg_iou,
    type_iou, matching, prim_pairs, recall) per shape."""
    p_arr = np.stack([np.asarray(p).astype(np.int64) for p in pred_labels])
    t_arr = np.stack([np.asarray(t).astype(np.int64) for t in targets])
    cost_all = _relaxed_cost_from_labels(
        torch.from_numpy(p_arr).to(device),
        torch.from_numpy(t_arr).to(device)).cpu().numpy()
    partial, all_pairs, spans = [], [], []
    for i in range(len(targets)):
        prim_per_seg = _prim_type_per_segment_np(
            p_arr[i], _remap_eval(np.asarray(primitives_pred[i])))
        seg_iou, prim_iou, matching, prim_pairs, _, cd_pairs = \
            _collect_matched(np.asarray(targets[i]), np.asarray(pred_labels[i]),
                             prim_per_seg, _remap_eval(np.asarray(primitives[i])),
                             cost_all[i], points=np.asarray(points[i]),
                             use_chamfer=True)
        spans.append((len(all_pairs), len(cd_pairs)))
        all_pairs.extend(cd_pairs)
        partial.append((seg_iou, prim_iou, matching, prim_pairs))
    cds = (_masked_chamfer_pairs(all_pairs, device) / 2.0 if all_pairs
           else np.zeros((0,), np.float32))
    out = []
    for (s0, cnt), (seg_iou, prim_iou, matching, prim_pairs), t in zip(
            spans, partial, targets):
        recall = int((cds[s0:s0 + cnt] < 0.1).sum()) / np.unique(
            np.asarray(t)).shape[0]
        out.append((seg_iou, prim_iou, matching, prim_pairs, recall))
    return out


def mean_iou_one_sample(pred: np.ndarray, gt: np.ndarray, c: int) -> float:
    """The IoU of each class 0 .. c-1 averaged over the c classes, a
    float32 epsilon on both sides of each ratio (reference:
    src/segment_utils.py:124-137)."""
    eps = np.finfo(np.float32).eps
    iou = 0.0
    for k in range(c):
        gi, pi = gt == k, pred == k
        iou += (np.logical_and(gi, pi).sum() + eps) / (
            np.logical_or(gi, pi).sum() + eps)
    return iou / c


def _mode(a: np.ndarray):
    vals, counts = np.unique(a, return_counts=True)
    return vals[np.argmax(counts)]


def _remap_abc(t: np.ndarray) -> np.ndarray:
    """The ABC type remap of `compute_type_miou_abc`: 6, 7 and 9 to 0, 8
    to 2 (reference: src/segment_utils.py:322-328)."""
    t = t.copy()
    t[(t == 6) | (t == 7) | (t == 9)] = 0
    t[t == 8] = 2
    return t


def compute_type_miou_abc(type_per_point: np.ndarray, t_gt: np.ndarray,
                          cluster_pred: np.ndarray, i_gt: np.ndarray) -> float:
    """HPNet-style per-instance type accuracy (reference:
    src/segment_utils.py:300-355): the predicted clusters matched to the
    true instances by the relaxed IoU (Hungarian), and the share of matched
    pairs whose most frequent remapped type agrees.

    type_per_point: (N, C) scores or (N,) ids; t_gt, cluster_pred, i_gt:
    (N,) ints, i_gt -1 for points of no instance."""
    t_pred = _remap_abc(type_per_point.argmax(-1) if type_per_point.ndim == 2
                        else type_per_point)
    t_gt = _remap_abc(t_gt)
    pred_hot = to_one_hot(cluster_pred, int(cluster_pred.max()) + 1)
    if i_gt.min() == -1:
        gt_hot = to_one_hot(i_gt + 1, int(i_gt.max()) + 2)[:, 1:]
    else:
        gt_hot = to_one_hot(i_gt, int(i_gt.max()) + 1)
    cost = 1.0 - relaxed_iou_fast(torch.from_numpy(pred_hot[None]),
                                  torch.from_numpy(
                                      np.ascontiguousarray(gt_hot)[None])
                                  ).numpy()[0]
    rows, cols = hungarian_match(cost)
    ok, cnt = 0, 0
    for p_ind, g_ind in zip(rows, cols):
        gt_sel = t_gt[i_gt == g_ind]
        pr_sel = t_pred[cluster_pred == p_ind]
        if gt_sel.size == 0 or pr_sel.size == 0:
            continue
        ok += int(_mode(gt_sel) == _mode(pr_sel))
        cnt += 1
    return ok / max(cnt, 1)
