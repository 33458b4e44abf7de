"""Exact k-nearest rows of a point set (kernel K1, `csrc/flash_topk.cu`).

Counterpart of `sednet_tpu/ops/flash_topk.py:topk_pallas`. For each row of
`q` it returns the k rows of `p` with the smallest distance (or the largest,
with `largest=True`), nearest first, ties broken by the lower index. Two
metrics, both with the expansion of the TPU kernel's `_dist_tile`:

  * "sqdist":          |q|^2 + |p|^2 - 2 q.p
  * "points_normals":  (|q3|^2 + |p3|^2 - 2 q3.p3) * (1 + w (2 - 2 qn.pn))

The kernel is the `torch.library` op `sednet::topk`, so that
`torch.export` can trace through it: a CUDA tensor launches the kernel, a
CPU tensor takes `topk_plain`, and the exported graph calls the op.

The TPU wrapper's Morton `spatial_sort` is a speed device for that kernel's
tile skip, not part of the result, and is not ported here.
"""
from __future__ import annotations

import torch

from sednet_tpu_torch.ops import _build

K_MAX = 128   # candidate-list length of the kernel
D_MAX = 256   # widest row the kernel stages in shared memory
METRICS = ("sqdist", "points_normals")


def _dist_plain(q, p, metric: str, w: float):
    """(M, N) distances with the kernel's expansion (float32 matmuls)."""
    if metric == "sqdist":
        qq = (q * q).sum(-1, keepdim=True)
        pp = (p * p).sum(-1)[None, :]
        return qq + pp - 2.0 * (q @ p.T)
    q3, p3 = q[:, :3], p[:, :3]
    qq = (q3 * q3).sum(-1, keepdim=True)
    pp = (p3 * p3).sum(-1)[None, :]
    dp = qq + pp - 2.0 * (q3 @ p3.T)
    dn = 2.0 - 2.0 * (q[:, 3:6] @ p[:, 3:6].T)
    return dp * (1.0 + w * dn)


def topk_plain(q, p, k: int, *, metric: str = "sqdist",
               normal_metric_w: float = 1.0, largest: bool = False,
               row_block: int = 1024):
    """Plain PyTorch version of the kernel: blocked matmul, then a stable
    sort so that equal distances keep the lower index first.

    q: (M, D) or (B, M, D); p: (N, D) or (B, N, D) (2-d p is shared by
    every batch row). Returns (distances float32, indices int64), each
    (..., M, k)."""
    squeeze = q.dim() == 2
    qb = q[None] if squeeze else q
    dists, idxs = [], []
    for b in range(qb.shape[0]):
        pb = p if p.dim() == 2 else p[b]
        db, ib = [], []
        for r0 in range(0, qb.shape[1], row_block):
            d = _dist_plain(qb[b, r0:r0 + row_block], pb, metric,
                            normal_metric_w)
            if largest:
                d = -d
            vals, order = torch.sort(d, dim=1, stable=True)
            vals = vals[:, :k]
            db.append(-vals if largest else vals)
            ib.append(order[:, :k])
        dists.append(torch.cat(db))
        idxs.append(torch.cat(ib))
    dist, idx = torch.stack(dists), torch.stack(idxs)
    return (dist[0], idx[0]) if squeeze else (dist, idx)


def _dist_at(q, p, idx, metric: str, w: float):
    """Distances (..., M, k) from each row of q to the rows idx of p, with
    the kernel's expansion (2-d p is shared by every batch row)."""
    squeeze = q.dim() == 2
    qb, ib = (q[None], idx[None]) if squeeze else (q, idx)
    out = []
    for b in range(qb.shape[0]):
        g = (p if p.dim() == 2 else p[b])[ib[b]]          # (M, k, D)
        qe = qb[b][:, None, :]
        if metric == "sqdist":
            d = ((qe * qe).sum(-1) + (g * g).sum(-1)
                 - 2.0 * (qe * g).sum(-1))
        else:
            q3, g3 = qe[..., :3], g[..., :3]
            dp = ((q3 * q3).sum(-1) + (g3 * g3).sum(-1)
                  - 2.0 * (q3 * g3).sum(-1))
            d = dp * (1.0 + w * (2.0 - 2.0 * (qe[..., 3:6] * g[..., 3:6])
                                 .sum(-1)))
        out.append(d)
    d = torch.stack(out)
    return d[0] if squeeze else d


def compare_with_plain(q, p, k, idx, dist, *, metric: str = "sqdist",
                       normal_metric_w: float = 1.0, largest: bool = False):
    """Hold a top-k result (idx, dist) against `topk_plain` on the same
    inputs. Two float32 orders of summation can swap neighbours whose
    distances differ by less than their rounding, so:

      * rounding scale: s = 1 + max |q|^2 (over xyz for points_normals,
        times 1 + 4w there, the most that 1 + w*dn can multiply);
      * the returned distances, and the plain distances to the returned
        neighbours (sorted), must both agree with the plain k smallest
        within 1e-5 * s, so a swapped-in neighbour lies at the distance of
        the one it replaced;
      * neighbour sets must be equal in every row whose plain k-th and
        (k+1)-th distances are more than 1e-6 * s apart.

    Returns {"bad_rows": sets differ outside a near-tie, "tie_rows": rows
    in a near-tie, "swapped_rows": sets differ, "rows", "max_abs_err":
    returned distances, "nbr_err": distances to the returned neighbours,
    "tol"}."""
    dp, ip = topk_plain(q, p, k + 1, metric=metric,
                        normal_metric_w=normal_metric_w, largest=largest)
    sq = q[..., :3] if metric == "points_normals" else q
    scale = (1.0 + float((sq * sq).sum(-1).max())) * (
        1.0 + 4.0 * abs(normal_metric_w) if metric == "points_normals"
        else 1.0)
    gap = (dp[..., k] - dp[..., k - 1]).abs()
    near_tie = gap <= 1e-6 * scale
    same = (torch.sort(idx, -1).values
            == torch.sort(ip[..., :k], -1).values).all(-1)
    at = torch.sort(_dist_at(q, p, idx, metric, normal_metric_w), -1,
                    descending=largest).values
    return {"bad_rows": int((~same & ~near_tie).sum()),
            "tie_rows": int(near_tie.sum()),
            "swapped_rows": int((~same).sum()),
            "rows": same.numel(),
            "max_abs_err": float((dist - dp[..., :k]).abs().max()),
            "nbr_err": float((at - dp[..., :k]).abs().max()),
            "tol": 1e-5 * scale}


def _launch(q, p, k, metric, w, largest):
    _build.require_cuda_f32("flash_topk q", q)
    _build.require_cuda_f32("flash_topk p", p)
    if q.device != p.device:
        raise ValueError("flash_topk: q and p on different devices")
    if q.dim() not in (2, 3) or p.dim() not in (2, 3):
        raise ValueError("flash_topk: q and p must be 2-d or 3-d")
    q3 = q[None] if q.dim() == 2 else q
    batch, m, d = q3.shape
    if p.dim() == 3 and p.shape[0] != batch:
        raise ValueError("flash_topk: batch sizes of q and p differ")
    n, dp = p.shape[-2:]
    if dp != d:
        raise ValueError(f"flash_topk: widths differ ({d} vs {dp})")
    if not 1 <= k <= min(K_MAX, n):
        raise ValueError(f"flash_topk: k={k} outside [1, min({K_MAX}, {n})]")
    if d > D_MAX or (metric == "points_normals" and d < 6):
        raise ValueError(f"flash_topk: width {d} not supported for {metric}")
    dist = torch.empty((batch, m, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((batch, m, k), dtype=torch.int32, device=q.device)
    err = _build.lib().sednet_topk(
        q3.data_ptr(), p.data_ptr(), m * d, 0 if p.dim() == 2 else n * d,
        batch, m, n, d, k, METRICS.index(metric), float(w), int(largest),
        dist.data_ptr(), idx.data_ptr(), _build.stream_of(q))
    _build.check(err, "flash_topk")
    flash_topk.launches += 1
    if q.dim() == 2:
        dist, idx = dist[0], idx[0]
    return dist, idx.long()


# K1 as the custom op `sednet::topk`: the dispatcher sends a CUDA tensor to
# the kernel and a CPU tensor to `topk_plain`; any other device has no
# implementation and raises. No autograd: the graphs it gives are indices.
@torch.library.custom_op("sednet::topk", mutates_args=(), device_types="cpu")
def _topk_op(q: torch.Tensor, p: torch.Tensor, k: int, metric: str,
             normal_metric_w: float, largest: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    return topk_plain(q, p, k, metric=metric,
                      normal_metric_w=normal_metric_w, largest=largest)


_topk_op.register_kernel("cuda")(_launch)


@_topk_op.register_fake
def _(q, p, k, metric, normal_metric_w, largest):
    shape = (*q.shape[:-1], k)
    return (q.new_empty(shape, dtype=torch.float32),
            q.new_empty(shape, dtype=torch.int64))


def flash_topk(q, p, k: int, *, metric: str = "sqdist",
               normal_metric_w: float = 1.0, largest: bool = False,
               return_distances: bool = False):
    """Exact top-k rows of p for every row of q (see the module docstring),
    through the op `sednet::topk` (`torch.ops.sednet.topk`).

    Returns int64 indices (..., M, k), and with return_distances also the
    float32 distances in the same order. On CUDA, q and p must be
    contiguous float32; k <= 128 and D <= 256."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    # the op has no gradient: its inputs go in detached, on either device
    dist, idx = torch.ops.sednet.topk(q.detach(), p.detach(), k, metric,
                                      float(normal_metric_w), bool(largest))
    return (idx, dist) if return_distances else idx


flash_topk.launches = 0
