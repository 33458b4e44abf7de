"""k-nearest-neighbour graphs of the DGCNN encoder, through kernel K1.

Counterpart of `sednet_tpu/ops/knn.py:138-200`. The reference's dilation
(k2 nearest, every (k2 // k1)-th kept) is the identity at the default
k1 == k2 == 64.
"""
from __future__ import annotations

from sednet_tpu_torch.ops.flash_topk import flash_topk


def _dilate(idx_k2, k1: int, k2: int):
    if k1 == k2:
        return idx_k2
    return idx_k2[..., ::k2 // k1][..., :k1]


def knn_indices(x, k1: int, k2: int | None = None):
    """x: (B, N, D) -> (B, N, k1) int64 nearest indices under squared
    euclidean distance, self included, nearest first."""
    k2 = k1 if k2 is None else k2
    x = x.contiguous()
    return _dilate(flash_topk(x, x, k2), k1, k2)


def knn_indices_points_normals(x, k1: int, k2: int | None = None, *,
                               normal_metric_w: float = 1.0):
    """x: (B, N, 6) xyz ++ unit normals -> (B, N, k1) indices under
    d_p * (1 + W * d_n) (reference: src/PointNet.py:90-137)."""
    k2 = k1 if k2 is None else k2
    x = x.contiguous()
    return _dilate(flash_topk(x, x, k2, metric="points_normals",
                              normal_metric_w=normal_metric_w), k1, k2)
