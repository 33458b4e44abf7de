"""Mean-shift clustering on the unit hypersphere, with the guarded retry.

Counterpart of `sednet_tpu/cluster/mean_shift.py:54-459` (reference:
src/mean_shift.py:11-186, generate_predictions_aug.py:25-35). The shift
steps run kernel K2 (one shape) or K2b (a batch), the bandwidth's k-th
distances come from kernel K1, and the three NMS passes run kernel K3.

Where the JAX package jits a fixed-shape loop, this runs eagerly with the
same semantics: the tol early exit stops after the first step whose max
movement is <= tol, and the retry loop multiplies the quantile by the
retry factor in float32 until at most `max_clusters` clusters remain (16
retries at most). Random subsamples come from a `torch.Generator`; tests
inject JAX's indices through `sel`, or a bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from sednet_tpu_torch.ops.cuda_kernels import (colmax, mean_shift_step,
                                               mean_shift_step_batched)
from sednet_tpu_torch.ops.flash_topk import K_MAX, flash_topk
from sednet_tpu_torch.ops.guard import guard_sqrt

DEFAULT_MS_TOL = 1e-6
_MIN_BANDWIDTH = 0.003
_MAX_RETRIES = 16


@dataclass
class MeanShiftResult:
    shifted: torch.Tensor       # (N, E) shifted points
    labels: torch.Tensor        # (N,) int64 compact cluster ids
    center_mask: torch.Tensor   # (N,) bool rows of `shifted` kept as centers
    num_clusters: int
    bandwidth: float
    quantile: np.float32        # after the retries
    tries: int = 0              # guarded retries taken
    capped: bool = False        # the retry cap was hit (labels folded)
    bw_capped: bool = False     # the bandwidth's k exceeded its cap


def bandwidth_k(quantile, m: int) -> int:
    """k = clip(int32(f32(quantile) * m), 1, min(m - 1, 256)), in float32
    as `compute_bandwidth` does (mean_shift.py:80-81)."""
    k = int(np.float32(quantile) * np.float32(m))
    return int(np.clip(k, 1, min(m - 1, 256)))


def compute_bandwidth(x, num_samples: int, quantile, *, generator=None,
                      sel=None):
    """Mean sqrt of the k-th smallest pairwise distance over a random
    subsample of m = min(num_samples, N) rows, k = quantile * m (self
    distance included). For k <= 128 the k-th distance comes from the
    top-k kernel's ascending distances; above, from the dense squared
    chord 2 - 2 s capped at 256 columns, as the TPU path branches
    (mean_shift.py:90-101). Returns a 0-d tensor."""
    n = x.shape[0]
    m = min(num_samples, n)
    if sel is None:
        sel = torch.randperm(n, generator=generator)[:m]
    xs = x[torch.as_tensor(sel, device=x.device)].contiguous()
    k = bandwidth_k(quantile, m)
    kp = min(K_MAX, m - 1)
    if k <= kp:
        _, dd = flash_topk(xs, xs, kp, return_distances=True)
        kth = dd[:, k - 1]
    else:
        dist = 2.0 - 2.0 * (xs @ xs.T)
        kth = -torch.topk(-dist, min(256, m), dim=1).values[:, k - 1]
    return guard_sqrt(kth, 1e-6).mean()


def _iterate_until(step, x, iterations: int, tol: float):
    cur = x
    for _ in range(iterations):
        nxt = step(cur)
        done = tol > 0.0 and float((nxt - cur).abs().max()) <= tol
        cur = nxt
        if done:
            break
    return cur


def mean_shift_iterate(x, bandwidth, iterations: int = 50,
                       tol: float = 0.0):
    """Up to `iterations` gaussian mean-shift steps of x (N, E) unit rows
    (K2), stopping early once the max movement is <= tol (0 disables)."""
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=x.device)
    return _iterate_until(lambda cur: mean_shift_step(cur, x, bw),
                          x, iterations, tol)


def nms(centers, x, b: float):
    """Non-max suppression (reference: src/mean_shift.py:139-179), as the
    three column-max passes of the JAX package. Returns (labels (N,)
    int64 compact ids, center_mask (N,) bool, num_clusters int)."""
    n = x.shape[0]
    inf = float("inf")
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    # nearest shifted center of every point (first index on ties)
    _, membership = colmax(x, centers, zeros, inf, 1.0)
    counts = torch.bincount(membership.long(), minlength=n).float()
    occupied = counts > 0
    # centers within the bandwidth vote for their heaviest neighbour
    _, rep = colmax(centers, centers, counts, b, 0.0)
    center_mask = torch.zeros(n, dtype=torch.int32, device=x.device)
    center_mask = center_mask.scatter_reduce(
        0, rep.long(), occupied.int(), reduce="amax") > 0
    # every point joins its most aligned surviving center
    masked = torch.where(center_mask, 0.0, -inf)
    _, raw = colmax(x, centers, masked, inf, 1.0)
    compact = torch.cumsum(center_mask.long(), 0) - 1
    return compact[raw.long()], center_mask, int(center_mask.sum())


def mean_shift(x, *, num_samples: int = 10000, quantile=0.015,
               iterations: int = 50, bandwidth=None, tol: float = 0.0,
               generator=None, sel=None) -> MeanShiftResult:
    """One clustering pass (reference: src/mean_shift.py:19-43)."""
    q = np.float32(quantile)
    if bandwidth is None:
        bandwidth = compute_bandwidth(x, num_samples, q, generator=generator,
                                      sel=sel)
        bandwidth = max(float(bandwidth), _MIN_BANDWIDTH)
    bandwidth = float(bandwidth)
    shifted = mean_shift_iterate(x, bandwidth, iterations, tol)
    labels, center_mask, num = nms(shifted, x, bandwidth)
    return MeanShiftResult(shifted, labels, center_mask, num, bandwidth, q)


def _cap(res: MeanShiftResult, max_clusters: int) -> MeanShiftResult:
    """Rank clusters by size (stable on ties); clusters past max_clusters
    fold into the largest (mean_shift.py:445-456)."""
    labels = res.labels
    n = labels.shape[0]
    sizes = torch.bincount(labels, minlength=n)
    order = torch.argsort(-sizes, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=labels.device)
    rl = rank[labels]
    return replace(res, labels=torch.where(rl < max_clusters, rl, 0),
                   num_clusters=min(res.num_clusters, max_clusters))


def guard_mean_shift(x, *, num_samples: int = 10000, quantile=0.015,
                     iterations: int = 50, max_clusters: int = 49,
                     retry_factor: float = 1.2, tol: float = DEFAULT_MS_TOL,
                     generator=None, sel=None,
                     bandwidth=None) -> MeanShiftResult:
    """Retry with the quantile times `retry_factor` (in float32) while
    there are more than max_clusters clusters.

    sel: optional subsample indices, one tensor for every attempt or a
    list with one per attempt (the last repeats). bandwidth: optional
    fixed bandwidth for every attempt."""
    sels = sel if isinstance(sel, (list, tuple)) else [sel]

    def attempt(q, i):
        return mean_shift(x, num_samples=num_samples, quantile=q,
                          iterations=iterations, bandwidth=bandwidth,
                          tol=tol, generator=generator,
                          sel=sels[min(i, len(sels) - 1)])

    res = attempt(np.float32(quantile), 0)
    tries = 0
    while res.num_clusters > max_clusters and tries < _MAX_RETRIES:
        tries += 1
        res = attempt(np.float32(res.quantile * np.float32(retry_factor)),
                      tries)
    m = min(num_samples, x.shape[0])
    res = replace(res, tries=tries, capped=res.num_clusters > max_clusters,
                  bw_capped=int(res.quantile * np.float32(m)) > min(m - 1, 256))
    return _cap(res, max_clusters) if res.capped else res


def cluster_batch(x, *, num_samples: int = 10000, quantile=0.015,
                  iterations: int = 50, max_clusters: int = 49,
                  retry_factor: float = 1.2, tol: float = DEFAULT_MS_TOL,
                  generator=None, sels=None):
    """Cluster a batch x (B, N, E): one bandwidth per shape, the shift
    steps of every shape in one launch (K2b) with a batch-global tol exit,
    per-shape NMS, and a guarded retry only for shapes with more than
    max_clusters clusters.

    Returns (labels (B, N) int64, num_clusters (B,) int64, flags) with
    flags {"capped", "bw_capped"} as (B,) bool arrays."""
    b = x.shape[0]
    sels = sels if sels is not None else [None] * b
    bw = torch.stack([torch.clamp_min(compute_bandwidth(
        x[i], num_samples, np.float32(quantile), generator=generator,
        sel=sels[i]), _MIN_BANDWIDTH) for i in range(b)])
    shifted = _iterate_until(
        lambda cur: mean_shift_step_batched(cur, x, bw), x, iterations, tol)
    bw_host = bw.tolist()
    labels, nums = [], np.zeros((b,), np.int64)
    capped = np.zeros((b,), bool)
    bw_capped = np.zeros((b,), bool)
    for i in range(b):
        lab, _, num = nms(shifted[i], x[i], bw_host[i])
        if num > max_clusters:
            res = guard_mean_shift(
                x[i], num_samples=num_samples,
                quantile=quantile * retry_factor, iterations=iterations,
                max_clusters=max_clusters, retry_factor=retry_factor,
                tol=tol, generator=generator)
            lab, num = res.labels, res.num_clusters
            capped[i], bw_capped[i] = res.capped, res.bw_capped
        labels.append(lab)
        nums[i] = num
    return (torch.stack(labels), torch.as_tensor(nums),
            {"capped": capped, "bw_capped": bw_capped})
