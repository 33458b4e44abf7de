"""Primitive-type losses and the type-mIoU train metric.

Counterpart of `sednet_tpu/losses/type_loss.py` (reference:
src/segment_loss.py:134-155 evaluate_miou, :204-226 the NLL and the
label-smoothing loss on log-probs).
"""
from __future__ import annotations

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _target_nll(type_log_prob, target):
    return -torch.gather(type_log_prob, -1, target[..., None].long())[..., 0]


def primitive_nll(type_log_prob, target):
    """NLL over log-probs. type_log_prob: (B, N, C); target: (B, N)."""
    return _target_nll(type_log_prob, target).mean()


def label_smoothing_nll(type_log_prob, target, smoothing: float = 0.025):
    """conf * NLL + smoothing * (-mean logprob)
    (reference: src/segment_loss.py:209-226)."""
    smooth = -type_log_prob.mean(-1)
    return ((1.0 - smoothing) * _target_nll(type_log_prob, target)
            + smoothing * smooth).mean()


def evaluate_type_miou(gt_labels, pred_log_prob):
    """Per-class IoU of argmax types (ties to the first index), averaged over
    classes then shapes, float32 eps added to both counts
    (reference: src/segment_loss.py:134-155).

    gt_labels: (B, N) int; pred_log_prob: (B, N, C)."""
    c = pred_log_prob.shape[-1]
    pred = pred_log_prob.argmax(-1)
    cls = torch.arange(c, device=pred.device)
    gt_m = gt_labels.long()[:, :, None] == cls
    pr_m = pred[:, :, None] == cls
    inter = (gt_m & pr_m).sum(1).float() + _F32_EPS
    union = (gt_m | pr_m).sum(1).float() + _F32_EPS
    return (inter / union).mean(-1).mean()
