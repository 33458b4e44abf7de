"""Instance re-clustering: split over-merged instances (counterpart of
`sednet_tpu/postproc/inst_cluster.py`, reference:
Fitting_patches_and_edges/inst_cluster.py:27-105).

An instance that holds at least `ratio_thresh` of the shape's points is
clustered again by mean-shift over its L2-normalised [normals, points,
one-hot(type)] rows (12 wide at 6 types; bandwidth quantile 0.5, 25 steps),
and its sub-clusters past the first take fresh instance ids. On the card
the bandwidth (quantile 0.5 puts its k above 128: the dense branch of
`compute_bandwidth`), the 25 shift steps (kernel K2, the rows padded once
to the kernel width) and the three NMS passes (kernel K3) run there.
"""
from __future__ import annotations

import numpy as np
import torch

from sednet_tpu_torch.cluster.mean_shift import mean_shift
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.ops.cuda_kernels import kernel_width


def subsample_size(rows: int) -> int:
    """The mean-shift subsample's num_samples for an instance of `rows`
    points: the power of two from 8 up to the first at or above rows // 4
    (JAX buckets it so that its jitted mean-shift compiles once a bucket,
    `inst_cluster.py:42-44`; the bucket sets the bandwidth's k)."""
    ns = 8
    while ns < rows // 4:
        ns *= 2
    return ns


def instance_features(points: np.ndarray, normals: np.ndarray,
                      types: np.ndarray, mask: np.ndarray,
                      num_types: int = 6) -> np.ndarray:
    """The rows mean-shift splits an instance on: [normals, points,
    one-hot(type)] of the points under mask, each L2-normalised (+1e-12),
    float32 (num_types + 6 wide)."""
    one_hot = np.eye(num_types, dtype=np.float32)[
        np.clip(types[mask], 0, num_types - 1)]
    feats = np.concatenate([normals[mask], points[mask, :3], one_hot], 1)
    feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
    return np.ascontiguousarray(feats, np.float32)


def resplit_instances(points: np.ndarray, normals: np.ndarray,
                      insts: np.ndarray, types: np.ndarray, *,
                      ratio_thresh: float = 0.15, num_types: int = 6,
                      quantile: float = 0.5, iterations: int = 25,
                      max_instances: int = 50, device=None, generator=None,
                      sels=None) -> np.ndarray:
    """Returns a new instance-label array: instances below ratio_thresh of
    the points unchanged, larger ones split by mean-shift sub-clustering
    while free ids (below max_instances, unused) remain.

    sels: optional {instance id: subsample indices into that instance's
    rows} for the bandwidths, one draw a split instance, in place of JAX's
    `fold_in(key, k)` permutations; an instance without one draws from
    `generator`."""
    dev = resolve_device(device)
    n = points.shape[0]
    out = insts.copy()
    used = set(np.unique(insts).tolist())
    free = [i for i in range(max_instances) if i not in used]
    sels = sels or {}

    for pid in np.unique(insts):
        mask = insts == pid
        if mask.sum() < n * ratio_thresh or not free:
            continue
        feats = instance_features(points, normals, types, mask, num_types)
        x = kernel_width(torch.from_numpy(feats).to(dev))
        sel = sels.get(int(pid))
        res = mean_shift(x, num_samples=subsample_size(feats.shape[0]),
                         quantile=quantile, iterations=iterations,
                         generator=generator,
                         sel=None if sel is None else torch.as_tensor(sel))
        if res.num_clusters <= 1:
            continue
        sub = res.labels.cpu().numpy()
        rows = np.nonzero(mask)[0]
        # the original id stays with sub-cluster 0; the rest take free ids
        for s in range(1, res.num_clusters):
            if not free:
                break
            out[rows[sub == s]] = free.pop(0)
    return out
