"""Chamfer distance by row-blocked nearest neighbour, with its custom
backward.

Counterpart of `sednet_tpu/ops/chamfer.py:30-121` (reference:
src/chamfer_distance/, src/utils.py:273-358), in plain PyTorch: the JAX
package has no Pallas kernel here either. `chamfer_index` and
`chamfer_distance` are differentiable through `_ChamferDists`, the
counterpart of JAX's `_chamfer_fwd` / `_chamfer_bwd` (:64-99): the
gradient goes through the saved argmin pairs, as the reference's CUDA
extension computes it.
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


class _ChamferDists(torch.autograd.Function):
    """(d1, d2) of `nn_distance`, differentiable in x (B, N, D) and
    y (B, M, D). With i1 the nearest y of each x and i2 the nearest x of
    each y, and g1, g2 the incoming gradients:

      dx = 2 g1 (x - y[i1]) - sum over the j with i2[j] = i of 2 g2[j] (y[j] - x[i])
      dy = 2 g2 (y - x[i2]) - sum over the i with i1[i] = j of 2 g1[i] (x[i] - y[j])

    The sums are `index_add_`, which on CUDA adds with atomics: the order
    of the adds, and so the last bits of the gradient, vary from run to
    run (as kernel K6b's do); on the CPU they are fixed."""

    @staticmethod
    def forward(ctx, x, y):
        d1, d2, i1, i2 = nn_distance(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        return d1, d2

    @staticmethod
    def backward(ctx, g1, g2):
        x, y, i1, i2 = ctx.saved_tensors
        b, n, d = x.shape
        m = y.shape[1]
        y_near = torch.gather(y, 1, i1[..., None].expand(b, n, d))
        x_near = torch.gather(x, 1, i2[..., None].expand(b, m, d))
        t1 = 2.0 * g1[..., None] * (x - y_near)   # (B, N, D)
        t2 = 2.0 * g2[..., None] * (y - x_near)   # (B, M, D)
        rows = torch.arange(b, device=x.device)[:, None]
        # the cross terms summed apart, then added, as JAX's segment_sum
        dx = t1.new_zeros(b * n, d).index_add_(
            0, (i2 + rows * n).reshape(-1), -t2.reshape(b * m, d))
        dy = t2.new_zeros(b * m, d).index_add_(
            0, (i1 + rows * m).reshape(-1), -t1.reshape(b * n, d))
        return t1 + dx.reshape(b, n, d), t2 + dy.reshape(b, m, d)


def chamfer_index(x, y):
    """Per-point squared nearest-neighbour distances both ways (d1, d2),
    differentiable in x and y (the reference's ChamferIndex,
    src/chamfer_distance/chamfer_distance.py:88-121)."""
    return _ChamferDists.apply(x, y)


def chamfer_distance(x, y, *, sqrt: bool = False):
    """Symmetric chamfer distance, mean over points then over the batch;
    sqrt=True takes the root of each distance (clamped at 1e-12) first."""
    d1, d2 = chamfer_index(x, y)
    if sqrt:
        d1 = torch.sqrt(torch.clamp_min(d1, 1e-12))
        d2 = torch.sqrt(torch.clamp_min(d2, 1e-12))
    return (d1.mean(-1) + d2.mean(-1)).mean() * 0.5
