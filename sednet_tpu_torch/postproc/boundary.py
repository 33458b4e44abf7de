"""Instance-boundary detection and face adjacency for post-processing.

A numpy copy of `sednet_tpu/postproc/boundary.py`; the same arithmetic in the
same order, so that both packages write the same files.

Rebuild of reference Fitting_patches_and_edges/proj_2_edge_utils.py:12-115.
The CUDA three_nn extension becomes a blocked numpy kNN (k=3) over
`utils.chunked.chunked_sqdist_blocks` (SURVEY §2.8).
"""
from __future__ import annotations

import numpy as np

from sednet_tpu_torch.utils.chunked import chunked_sqdist_blocks

MAX_INSTANCES = 50


def three_nn_indices(points: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N, 3) indices of the 3 nearest points (self first) —
    the pointnet2 three_nn interface (reference:
    pointnet2/_ext_src/src/interpolate.cpp via proj_2_edge_utils.py:48).

    Host-side chunked numpy: the jitted kNN op would retrace for every
    distinct post-filter point count (pipeline.process_shape calls this on
    boundary/bad-point-filtered sets whose size differs per shape), and at
    k=3 the device offers no advantage over a blocked argpartition."""
    p = points[:, :3].astype(np.float32)
    n = p.shape[0]
    out = np.empty((n, 3), np.int64)
    for lo, hi, d2 in chunked_sqdist_blocks(p, p):
        k = min(3, n)
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        row = np.take_along_axis(d2, part, axis=1)
        idx = np.take_along_axis(part, np.argsort(row, axis=1), axis=1)
        if k < 3:  # degenerate tiny inputs: repeat the last column
            idx = np.concatenate(
                [idx] + [idx[:, -1:]] * (3 - k), axis=1)
        out[lo:hi] = idx
    return out


def boundary_edge_mask(points: np.ndarray, insts: np.ndarray,
                       strict: bool = True) -> np.ndarray:
    """Points whose 1st (and 2nd if strict) nearest neighbours belong to a
    different instance (reference: proj_2_edge_utils.py:45-60)."""
    nn = three_nn_indices(points[:, :3])
    one_diff = insts[nn[:, 1]] != insts
    if not strict:
        return one_diff
    two_diff = insts[nn[:, 2]] != insts
    return one_diff & two_diff


def bad_points_mask(points: np.ndarray, insts: np.ndarray,
                    primitive_ids: np.ndarray, parameters: dict,
                    plane_thresh: float = 0.05,
                    cylinder_thresh: float = 0.03) -> np.ndarray:
    """High-residual points w.r.t. their instance's fitted plane/cylinder
    (reference: proj_2_edge_utils.py:12-43)."""
    bad = np.zeros(points.shape[0], bool)
    for i, pid in enumerate(primitive_ids):
        par = parameters.get(i)
        if par is None:
            continue
        idx = np.nonzero(insts == pid)[0]
        p = points[idx]
        if par[0] == "plane":
            a, d = np.asarray(par[1]).reshape(3), float(par[2])
            residual = np.abs(p @ a - d)
            bad[idx[residual > plane_thresh]] = True
        elif par[0] == "cylinder":
            a = np.asarray(par[1]).reshape(3)
            c = np.asarray(par[2]).reshape(3)
            r = float(par[3])
            v = p - c
            lat = np.sqrt(np.clip((v * v).sum(1) - (v @ a) ** 2, 0, None))
            bad[idx[np.abs(lat - r) > cylinder_thresh]] = True
    return bad


def face_adjacency(points: np.ndarray, insts: np.ndarray,
                   primitive_ids: np.ndarray, nn_num_thresh: int = 3,
                   max_instances: int = MAX_INSTANCES) -> np.ndarray:
    """Instance adjacency: instances are neighbours when >= nn_num_thresh of
    one's points have a 1st/2nd NN in the other; isolated instances get
    their globally nearest instance (reference: proj_2_edge_utils.py:62-115).
    """
    nn = three_nn_indices(points[:, :3])
    mat = np.zeros((max_instances, max_instances), bool)
    for pid in primitive_ids:
        own = insts == pid
        votes = []
        for col in (1, 2):
            nbr_inst = insts[nn[own, col]]
            votes.append(nbr_inst[nbr_inst != pid])
        votes = np.concatenate(votes) if votes else np.zeros(0, insts.dtype)
        uniq, counts = np.unique(votes, return_counts=True)
        for u, c in zip(uniq, counts):
            if c >= nn_num_thresh:
                mat[int(pid), int(u)] = True
    # lonely instances: connect to the nearest other instance
    for pid in primitive_ids:
        if mat[int(pid)].any():
            continue
        own = insts == pid
        if own.sum() == 0:
            continue
        # nearest instance to the WHOLE instance (min over all own points),
        # not to an arbitrary first point — an elongated instance's single
        # endpoint can be closest to the wrong primitive
        other_idx = np.nonzero(~own)[0]
        if other_idx.size == 0:
            continue
        po = points[own, :3]
        pt = points[other_idx, :3]
        dmin = np.full(other_idx.shape[0], np.inf, np.float32)
        for lo, hi, d2 in chunked_sqdist_blocks(pt, po):
            dmin[lo:hi] = np.minimum(dmin[lo:hi], d2.min(1))
        mat[int(pid), int(insts[other_idx[np.argmin(dmin)]])] = True
    return mat
