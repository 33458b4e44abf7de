"""Chamfer distance by row-blocked nearest neighbour, forward only.

Counterpart of `sednet_tpu/ops/chamfer.py:30-121` (reference:
src/chamfer_distance/, src/utils.py:273-358), in plain PyTorch: the JAX
package has no Pallas kernel here either. The metric stage needs only the
forward; the custom backward waits for the training slice.
"""
from __future__ import annotations

import torch

from sednet_tpu_torch.ops.knn import pairwise_sqdist


def _nn_one_direction(x, y, row_block: int):
    """For each row of x (N, D): min_j |x_i - y_j|^2 and its argmin (first
    on ties). Returns (dist (N,), idx (N,) int64)."""
    dist, idx = [], []
    for r0 in range(0, x.shape[0], row_block):
        d = pairwise_sqdist(x[r0:r0 + row_block], y)
        v, i = d.min(dim=-1)
        dist.append(v)
        idx.append(i)
    return torch.cat(dist), torch.cat(idx)


def nn_distance(x, y, *, row_block: int = 1024):
    """Two-sided nearest neighbour of x (B, N, D) and y (B, M, D).
    Returns (d1 (B, N), d2 (B, M), i1 (B, N), i2 (B, M)): squared
    distances and argmin indices both ways."""
    one = [_nn_one_direction(a, b, row_block) for a, b in zip(x, y)]
    two = [_nn_one_direction(b, a, row_block) for a, b in zip(x, y)]
    return (torch.stack([o[0] for o in one]), torch.stack([t[0] for t in two]),
            torch.stack([o[1] for o in one]), torch.stack([t[1] for t in two]))


def chamfer_index(x, y):
    """Per-point squared nearest-neighbour distances both ways (d1, d2)."""
    d1, d2, _, _ = nn_distance(x, y)
    return d1, d2


def chamfer_distance(x, y, *, sqrt: bool = False):
    """Symmetric chamfer distance, mean over points then over the batch;
    sqrt=True takes the root of each distance (clamped at 1e-12) first."""
    d1, d2 = chamfer_index(x, y)
    if sqrt:
        d1 = torch.sqrt(torch.clamp_min(d1, 1e-12))
        d2 = torch.sqrt(torch.clamp_min(d2, 1e-12))
    return (d1.mean(-1) + d2.mean(-1)).mean() * 0.5
