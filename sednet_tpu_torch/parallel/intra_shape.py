"""Intra-shape (point-axis) parallelism: ring kNN and the sharded shift.

Counterpart of `sednet_tpu/parallel/intra_shape.py`. One cloud's points
are split into equal row shards over the ranks of a `Mesh`:

  * `ring_knn`: every rank holds its rows (the queries) and one column
    shard (the candidates, its own at first). Each of the mesh's steps
    runs kernel K1 on the rows against the resident shard, keyed by the
    shard's global indices (K1's column-id table), merges the result into
    the running top-k by (value, global index), and passes the shard one
    rank on around the ring (`batch_isend_irecv`). Ties go to the lower
    global index, as in the single-device K1, so the result is its.
  * `mean_shift_iterate_sharded`: the anchors are all-gathered once; then
    every iteration is kernel K2 on the rank's rows against all anchors,
    with no collective inside the loop.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from sednet_tpu_torch.ops.flash_topk import flash_topk
from sednet_tpu_torch.parallel.mesh import Mesh, all_gather_rows


def _merge(best_d, best_i, d, i, k):
    """The k smallest of two lists by (value, index): one stable sort by
    index, then one by value."""
    cat_d = torch.cat([best_d, d], 1)
    cat_i = torch.cat([best_i, i], 1)
    by_i = torch.argsort(cat_i, dim=1, stable=True)
    cat_d, cat_i = cat_d.gather(1, by_i), cat_i.gather(1, by_i)
    by_d = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
    return cat_d.gather(1, by_d), cat_i.gather(1, by_d)


def ring_knn(x_rows, k: int, mesh: Mesh, *, metric: str = "sqdist",
             normal_metric_w: float = 1.0):
    """Exact self-kNN of a cloud whose rows are sharded over `mesh`:
    x_rows (N/M, D) this rank's rows (rank r holds rows r N/M ..). Returns
    (idx (N/M, k) int64 global indices nearest first, dist (N/M, k)), the
    rows of the single-device K1's answer, ties to the lower global index.
    No rank ever holds more than two (N/M, D) shards."""
    x_rows = x_rows.contiguous()
    shard = x_rows.shape[0]
    cols = x_rows
    best_d = best_i = None
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    for t in range(mesh.size):
        owner = (mesh.rank - t) % mesh.size
        ids = torch.arange(owner * shard, (owner + 1) * shard,
                           dtype=torch.int32, device=x_rows.device)
        if t + 1 < mesh.size:
            # send the resident shard on while this step's K1 runs
            incoming = torch.empty_like(cols)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cols, nxt, group=mesh.group),
                dist.P2POp(dist.irecv, incoming, prv, group=mesh.group)])
        i, d = flash_topk(x_rows, cols, min(k, shard), metric=metric,
                          normal_metric_w=normal_metric_w,
                          return_distances=True, spatial_sort=False,
                          col_ids=ids)
        best_d, best_i = ((d, i) if best_d is None
                          else _merge(best_d, best_i, d, i, k))
        if t + 1 < mesh.size:
            for r in reqs:
                r.wait()
            cols = incoming
    return best_i[:, :k], best_d[:, :k]


def mean_shift_iterate_sharded(x_rows, bandwidth, mesh: Mesh,
                               iterations: int = 50,
                               kernel_type: str = "gaussian"):
    """`cluster.mean_shift.mean_shift_iterate` (fixed trip, no early exit)
    with the shifted rows sharded over the mesh: x_rows (N/M, E) this
    rank's unit rows. The anchors (every rank's rows) are all-gathered
    once; each iteration is then one K2 step of the rank's rows against
    them (an epanechnikov step for kernel_type "epanechnikov"), with no
    collective. Returns this rank's shifted rows."""
    from sednet_tpu_torch.cluster.mean_shift import (KERNEL_TYPES,
                                                     epanechnikov_step)
    from sednet_tpu_torch.ops.cuda_kernels import mean_shift_step

    if kernel_type not in KERNEL_TYPES:
        raise ValueError(f"kernel_type {kernel_type!r} not in {KERNEL_TYPES}")
    cur = x_rows.contiguous()
    anchors = all_gather_rows(cur, mesh)
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=cur.device)
    for _ in range(iterations):
        if kernel_type == "epanechnikov":
            cur = epanechnikov_step(cur, anchors, bw)
        else:
            cur = mean_shift_step(cur, anchors, bw)
    return cur
