"""Soft-IoU losses with Hungarian reordering, and the edge/instance-boundary
consistency loss (counterpart of `sednet_tpu/losses/iou_loss.py`,
reference: src/my_iou_loss.py).

  * `miou_loss`: soft IoU between per-class scores and one-hot targets,
    with an optional matched-channel gather and GT-channel mask (:8-46);
  * `miou_loss_weighted`: per-shape weights from instance counts (:49-96);
  * `reorder_pred_idx`: Hungarian assignment of GT segment ids onto the
    predicted channels from the argmax-overlap IoU (:147-188), on the host;
  * `miou_loss_edge`: IoU between the predicted edge points and the
    instance boundary that the predicted instances' nearest-neighbour
    disagreement implies (:227-244), through `ops.pointnet2.three_nn`
    (kernel K1 on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from sednet_tpu_torch.metrics.segmentation import hungarian_match
from sednet_tpu_torch.ops.pointnet2 import three_nn


def _soft_iou(inputs, target_one_hot, matching_indices):
    b, c, _ = inputs.shape
    if matching_indices is not None:
        inputs = torch.gather(inputs, 1, matching_indices)
    inter = (inputs * target_one_hot).reshape(b, c, -1).sum(2)
    union = (inputs + target_one_hot - inputs * target_one_hot
             ).reshape(b, c, -1).sum(2)
    return inter / torch.where(union == 0, 1.0, union)


def miou_loss(inputs, target_one_hot, matching_indices=None, gt_mask=None):
    """inputs (B, C, N) scores; target_one_hot (B, C, N); optional
    matching_indices (B, C, N) int64 gathers input channels into target
    order; gt_mask (B, C) bool restricts the average to present GT
    channels. Returns 1 - mean soft IoU (my_iou_loss.py:13-46)."""
    iou = _soft_iou(inputs, target_one_hot, matching_indices)
    if gt_mask is None:
        return 1.0 - iou.mean()
    masked = torch.where(gt_mask, iou, 0.0).sum(-1)
    denom = torch.clamp_min(gt_mask.sum(), 1)
    return 1.0 - masked.sum() / denom


def miou_loss_weighted(inputs, target_one_hot, matching_indices=None,
                       gt_mask=None, abs_w: bool = False):
    """Per-shape weights from instance counts (my_iou_loss.py:49-96); the
    weights carry no gradient."""
    iou = _soft_iou(inputs, target_one_hot, matching_indices)
    present = target_one_hot.sum(-1) > 0                     # (B, C)
    if gt_mask is not None:
        present = present & gt_mask
        iou = torch.where(gt_mask, iou, 0.0)
    counts = present.sum(-1).to(torch.float32)               # (B,)
    if abs_w:
        w = (counts / 8.0) ** 1.3
        w = w / torch.clamp_min(w.sum(), 1e-8)
    else:
        w = counts / torch.clamp_min(counts.sum(), 1e-8)
    return 1.0 - (iou.mean(-1) * w.detach()).sum()


def reorder_pred_idx(inputs: np.ndarray, target: np.ndarray):
    """Hungarian alignment of GT segment ids to predicted channels.

    inputs (B, C, N) scores; target (B, N) GT segment ids, -1 for noise
    points, which belong to no GT segment (the reference builds each
    one-hot from target == j for j >= 0, my_iou_loss.py:158-166).
    Returns (matching_indices (B, N, C) int64, whose first
    target_inst_num[i] columns of shape i hold the matched channels,
    target_inst_num (B,))."""
    inputs_idx = np.argmax(inputs, axis=1)                   # (B, N)
    b, c, n = inputs.shape
    target_inst_num = target.max(-1) + 1
    matching = np.zeros((b, n, c), np.int64)
    for i in range(b):
        t = target[i]
        gt_oh = np.zeros((n, c), np.float64)
        valid = t >= 0
        gt_oh[valid, np.clip(t[valid], 0, c - 1)] = 1.0
        pr_oh = np.eye(c, dtype=np.float64)[inputs_idx[i]]
        inter = gt_oh.T @ pr_oh                              # (C, C)
        union = gt_oh.sum(0)[:, None] + pr_oh.sum(0)[None, :] - inter
        mat = np.where(union > 0, inter / np.where(union == 0, 1, union), 0.0)
        k = int(target_inst_num[i])
        _, col = hungarian_match(-mat[:k, :])
        matching[i, :, :k] = col
    return matching, target_inst_num


def miou_loss_edge(points, inst_scores, edge_logits):
    """IoU between the predicted edge points and the predicted instances'
    boundary (a point whose nearest other point, the second of its three
    nearest, holds another instance) (my_iou_loss.py:227-244).

    points (B, N, 3); inst_scores (B, C, N); edge_logits (B, N, 2)."""
    inst_pred = inst_scores.argmax(1)                        # (B, N)
    _, nn_idx = three_nn(points, points)                     # (B, N, 3)
    nn_inst = torch.gather(inst_pred, 1, nn_idx[..., 1])
    inst_edge = (nn_inst != inst_pred).to(torch.float32)
    edge_pred = (edge_logits.argmax(-1) == 1).to(torch.float32)
    inter = (inst_edge * edge_pred).sum(-1)
    union = inst_edge.sum(-1) + edge_pred.sum(-1) - inter + 1e-7
    return 1.0 - (inter / union).mean()
