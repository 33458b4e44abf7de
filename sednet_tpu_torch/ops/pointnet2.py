"""The pointnet2 op family (counterpart of `sednet_tpu/ops/pointnet2.py`).

The reference's vendored CUDA extension
(Fitting_patches_and_edges/pointnet2/_ext_src/src/bindings.cpp:11-24):
furthest point sampling, gather, three_nn, three_interpolate, ball_query
and group_points. `three_nn` runs kernel K1 (`flash_topk`, k = 3, with its
distances), as the JAX package runs `topk_pallas` on the TPU; the others
are plain PyTorch on every device, as JAX runs them as XLA. Channels last:
points (B, N, 3), features (B, N, C).

Where a result decides a discrete choice (FPS's argmax, ball_query's
radius test), the squared distances are taken coordinate by coordinate,
(x - y)^2 summed over x, y, z in that order, elementwise ops that round
the same way on the card and on the CPU, so that both pick the same
points.
"""
from __future__ import annotations

import torch

from sednet_tpu_torch.ops.flash_topk import flash_topk


def _sqdist_exact(a, b):
    """Squared distances between the rows of a (..., M, 3) and b
    (..., N, 3) -> (..., M, N), summed x, y, z in order."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _batch_index(t, idx):
    """t (B, N, ...) gathered along N by idx (B, ...) -> (B, ..., ...)."""
    b = torch.arange(t.shape[0], device=t.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return t[b, idx]


def furthest_point_sampling(points, n_samples: int):
    """(B, N, 3) -> (B, n_samples) int64 indices: index 0 first, then each
    time the point farthest from those taken (the largest of its least
    squared distance to them; the first index on ties), as
    `sednet_tpu/ops/pointnet2.py:26-47` and the reference's
    sampling_gpu.cu. A loop of n_samples - 1 steps over the batch."""
    b, n, _ = points.shape
    idx = torch.zeros((b, n_samples), dtype=torch.int64, device=points.device)
    min_d = torch.full((b, n), float("inf"), device=points.device)
    rows = torch.arange(b, device=points.device)
    for i in range(1, n_samples):
        last = points[rows, idx[:, i - 1]]                    # (B, 3)
        d = _sqdist_exact(last[:, None, :], points)[:, 0]    # (B, N)
        min_d = torch.minimum(min_d, d)
        idx[:, i] = torch.argmax(min_d, dim=1)
    return idx


def gather_operation(features, idx):
    """(B, N, C), (B, M) -> (B, M, C)."""
    return _batch_index(features, idx)


def three_nn(unknown, known):
    """The 3 nearest known points of each unknown point: (B, N, 3),
    (B, M, 3) -> (dist (B, N, 3) euclidean, idx (B, N, 3) int64), nearest
    first, ties to the lower index. Kernel K1 on the card (`flash_topk`,
    k = 3, with distances), `topk_plain` on the CPU; the squared distances
    clamped at 0 before the root, as `sednet_tpu/ops/pointnet2.py:56-74`."""
    idx, d = flash_topk(unknown.contiguous(), known.contiguous(), 3,
                        return_distances=True)
    return torch.sqrt(torch.clamp_min(d, 0.0)), idx


def three_interpolate(features, idx, weight):
    """Weighted interpolation from 3 neighbours: features (B, M, C), idx
    (B, N, 3), weight (B, N, 3) -> (B, N, C). Differentiable by autograd
    (the reference's extension writes the gradient by hand)."""
    return (_batch_index(features, idx) * weight[..., None]).sum(2)


def interpolation_weights(dist, eps: float = 1e-8):
    """Inverse-distance weights for `three_interpolate` (reference:
    pointnet2_modules.py, the FP module)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(-1, keepdim=True)


def ball_query(centers, points, *, radius: float, n_sample: int):
    """Indices of up to n_sample points within radius of each center:
    centers (B, M, 3), points (B, N, 3) -> (idx (B, M, n_sample) int64,
    count (B, M) int32). The first n_sample points inside (squared distance
    <= radius^2) in index order; the slots past the count repeat the first
    hit, and a center with no hit gets n_sample zeros and count 0
    (`sednet_tpu/ops/pointnet2.py:101-122`, the reference's
    ball_query_gpu.cu). One shape at a time: its (M, N) distances."""
    n = points.shape[1]
    ar = torch.arange(n, device=points.device)
    slot = torch.arange(n_sample, device=points.device)[None, :]
    idxs, counts = [], []
    for c, p in zip(centers, points):
        inside = _sqdist_exact(c, p) <= radius * radius
        key = torch.where(inside, ar[None, :], n + ar[None, :])
        sel = torch.topk(key, n_sample, dim=1, largest=False).indices
        count = torch.clamp_max(inside.sum(-1), n_sample)
        sel = torch.where(slot < torch.clamp_min(count, 1)[:, None], sel,
                          sel[:, :1])
        idxs.append(sel)
        counts.append(count.to(torch.int32))
    return torch.stack(idxs), torch.stack(counts)


def group_points(features, idx):
    """(B, N, C), (B, M, K) -> (B, M, K, C) (reference:
    group_points_gpu.cu; the gradient by autograd)."""
    return _batch_index(features, idx)
