"""Mean-shift clustering on the unit hypersphere, with the guarded retry.

Counterpart of `sednet_tpu/cluster/mean_shift.py:54-459` (reference:
src/mean_shift.py:11-186, generate_predictions_aug.py:25-35). The gaussian
shift steps run kernel K2 (one shape) or K2b (a batch), with bf16 tile
inputs under `bf16=True` (`config.ms_bf16`, the Pallas kernels' branch),
the bandwidth's k-th distances come from kernel K1, and the three NMS
passes run kernel K3. The epanechnikov kernel (`kernel_type`) is JAX's XLA
step in plain PyTorch on every device, as JAX takes its Pallas step only
for the gaussian kernel (`mean_shift.py:168-169`); it reads no `bf16`, as
that step does not.

Where the JAX package jits a fixed-shape loop, this runs eagerly with the
same semantics: the tol early exit stops after the first step whose max
movement is <= tol, and the retry loop multiplies the quantile by the
retry factor in float32 until at most `max_clusters` clusters remain (16
retries at most). Random subsamples come from a `torch.Generator`; tests
inject JAX's indices through `sel`, or a bandwidth.

`cluster_batch` is `cluster_batch_finalize(cluster_batch_async(...))`, as
in the JAX package (`sednet_tpu/cluster/mean_shift.py:328,347`). The async
half (bandwidths, the batched shift loop) reads nothing back to the host:
its tol exit is a flag on the device that freezes the rows of every later
step, which gives the rows of the early exit. The finalize half reads the
bandwidths, runs NMS, reads the cluster counts once, and retries the
shapes with too many clusters. `guard_mean_shift` (one shape) keeps the
loop that reads each step's movement on the host and stops.

While a profiler runs, the finalize half records, once a batch, the counts
(`utils.tracing.count`) `cluster/ms_steps_run`, the steps launched;
`cluster/ms_steps_needed`, those up to and including the one that set the
tol flag (the async half counts the steps after it on the device); and
`cluster/guard_retries`, the guard's attempts after the batch pass.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from sednet_tpu_torch.ops.cuda_kernels import (colmax, kernel_width,
                                               mean_shift_step,
                                               mean_shift_step_batched,
                                               step_columns)
from sednet_tpu_torch.ops.flash_topk import K_MAX, flash_topk
from sednet_tpu_torch.ops.guard import guard_sqrt
from sednet_tpu_torch.utils.tracing import count, tracing_on

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


def _iterate_on_device(step, x, iterations: int, tol: float, after=None):
    """`_iterate_until` without a host read: every step runs, and once a
    step has moved no coordinate by more than tol, the steps after it keep
    its rows (torch.where on a done flag held on the device). The steps
    after the exit still cost their time: that is the price of queuing
    the loop without waiting on the device. after: a 0-d int32 tensor on
    x's device that gains one for each step launched after the exit."""
    cur = x
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(iterations):
        nxt = step(cur)
        if tol > 0.0:
            if after is not None:
                after += done
            nxt = torch.where(done, cur, nxt)
            done = done | ((nxt - cur).abs().max() <= tol)
        cur = nxt
    return cur


KERNEL_TYPES = ("gaussian", "epanechnikov")


def epanechnikov_step(new_x, x, bandwidth):
    """One epanechnikov mean-shift step, JAX's XLA step
    (`sednet_tpu/cluster/mean_shift.py:180-188`, reference:
    src/mean_shift.py:66-68): k = relu(0.75 (1 - d / b^2)) with
    d = 2 - 2 new_x . x, new_x = (k @ x) / k.1, rows normalised with the
    norm clipped at 1e-12."""
    dist = 2.0 - 2.0 * (new_x @ x.T)
    k = torch.relu(0.75 * (1.0 - dist / (bandwidth * bandwidth)))
    out = (k @ x) * (1.0 / k.sum(1, keepdim=True))
    return out / torch.clamp_min(
        torch.linalg.vector_norm(out, dim=1, keepdim=True), 1e-12)


def _step_inputs(x, width, bf16):
    """(start, columns) of a loop of gaussian shift steps on x, which is
    zero past its true width `width` (None: x's own): under bf16 on a CUDA
    device x's first `width` columns at the bf16 step's kernel width
    (`kernel_width(..., bf16=True)`: 140 runs at 144 where K1 and K3 take
    160) and their bf16 rounding (`step_columns`), made once for the loop;
    otherwise x for both."""
    if bf16 and x.is_cuda:
        x = kernel_width(x[..., :width], bf16=True)
    return x, step_columns(x, bf16)


def _to_width(t, w):
    """A loop's result t, zero past the loop's true width, at width w."""
    if t.shape[-1] > w:
        return t[..., :w].contiguous()
    return F.pad(t, (0, w - t.shape[-1])) if t.shape[-1] < w else t


def mean_shift_iterate(x, bandwidth, iterations: int = 50,
                       tol: float = 0.0, *, kernel_type: str = "gaussian",
                       bf16: bool = False, width=None):
    """Up to `iterations` mean-shift steps of x (N, E) unit rows, stopping
    early once the max movement is <= tol (0 disables): gaussian on K2
    (bf16 tile inputs under bf16=True), or epanechnikov. width: x's true
    width where x is zero-padded past it (the bf16 steps then run at their
    own kernel width); the result has x's width."""
    if kernel_type not in KERNEL_TYPES:
        raise ValueError(f"kernel_type {kernel_type!r} not in {KERNEL_TYPES}")
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=x.device)
    if kernel_type == "epanechnikov":
        return _iterate_until(lambda cur: epanechnikov_step(cur, x, bw),
                              x, iterations, tol)
    start, cols = _step_inputs(x, width, bf16)
    return _to_width(_iterate_until(
        lambda cur: mean_shift_step(cur, cols, bw, bf16=bf16), start,
        iterations, tol), x.shape[-1])


def nms_device(centers, x, b: float):
    """Non-max suppression (reference: src/mean_shift.py:139-179), as the
    three column-max passes of the JAX package, with no host read.
    Returns (labels (N,) int64 compact ids, center_mask (N,) bool,
    num_clusters as a 0-d tensor)."""
    n = x.shape[0]
    inf = float("inf")
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    # nearest shifted center of every point (first index on ties)
    _, membership = colmax(x, centers, zeros, inf, 1.0)
    # a count per center (exact in float32); bincount would read the
    # largest index back to size its output
    counts = torch.zeros(n, dtype=torch.float32, device=x.device).index_add_(
        0, membership.long(), torch.ones(n, device=x.device))
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
    return compact[raw.long()], center_mask, center_mask.sum()


def nms(centers, x, b: float):
    """`nms_device` with the cluster count read back as an int."""
    labels, center_mask, num = nms_device(centers, x, b)
    return labels, center_mask, int(num)


def mean_shift(x, *, num_samples: int = 10000, quantile=0.015,
               iterations: int = 50, kernel_type: str = "gaussian",
               bandwidth=None, bf16: bool = False, tol: float = 0.0,
               generator=None, sel=None, width=None) -> MeanShiftResult:
    """One clustering pass (reference: src/mean_shift.py:19-43); a drawn
    bandwidth is clipped at 0.003 (`_MIN_BANDWIDTH`) as JAX's is
    (`mean_shift.py:298`). width: as in `mean_shift_iterate`."""
    q = np.float32(quantile)
    if bandwidth is None:
        bandwidth = compute_bandwidth(x, num_samples, q, generator=generator,
                                      sel=sel)
        bandwidth = max(float(bandwidth), _MIN_BANDWIDTH)
    bandwidth = float(bandwidth)
    shifted = mean_shift_iterate(x, bandwidth, iterations, tol,
                                 kernel_type=kernel_type, bf16=bf16,
                                 width=width)
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


def _guarded(x, e, first, attempt, *, num_samples, max_clusters,
             retry_factor) -> MeanShiftResult:
    """The guard's retry loop after a first attempt `first` (try 0):
    attempt(q, i) is try i, at the previous quantile times retry_factor
    in float32, while more than max_clusters clusters remain, up to
    _MAX_RETRIES tries after the first. x is the kernel-width input, e its
    true width."""
    res, tries = first, 0
    while res.num_clusters > max_clusters and tries < _MAX_RETRIES:
        tries += 1
        res = attempt(np.float32(res.quantile * np.float32(retry_factor)),
                      tries)
    m = min(num_samples, x.shape[0])
    res = replace(res, shifted=res.shifted[:, :e], tries=tries,
                  capped=res.num_clusters > max_clusters,
                  bw_capped=int(res.quantile * np.float32(m)) > min(m - 1, 256))
    return _cap(res, max_clusters) if res.capped else res


def _attempts(x, sels, *, num_samples, iterations, tol, generator,
              bandwidth=None, kernel_type="gaussian", bf16=False, width=None):
    """attempt(q, i): one mean-shift pass of x (the kernel-width input, of
    true width `width`) at quantile q with the subsample sels[i] (the last
    repeats)."""
    def attempt(q, i):
        return mean_shift(x, num_samples=num_samples, quantile=q,
                          iterations=iterations, kernel_type=kernel_type,
                          bandwidth=bandwidth, bf16=bf16, tol=tol,
                          generator=generator,
                          sel=sels[min(i, len(sels) - 1)], width=width)
    return attempt


def guard_mean_shift(x, *, num_samples: int = 10000, quantile=0.015,
                     iterations: int = 50, kernel_type: str = "gaussian",
                     max_clusters: int = 49, retry_factor: float = 1.2,
                     bf16: bool = False, tol: float = DEFAULT_MS_TOL,
                     generator=None, sel=None,
                     bandwidth=None) -> MeanShiftResult:
    """Retry with the quantile times `retry_factor` (in float32) while
    there are more than max_clusters clusters.

    sel: optional subsample indices, one tensor for every attempt or a
    list with one per attempt (the last repeats). bandwidth: optional
    fixed bandwidth for every attempt."""
    e = x.shape[-1]
    x = kernel_width(x)
    attempt = _attempts(x, sel if isinstance(sel, (list, tuple)) else [sel],
                        num_samples=num_samples, iterations=iterations,
                        tol=tol, generator=generator, bandwidth=bandwidth,
                        kernel_type=kernel_type, bf16=bf16, width=e)
    return _guarded(x, e, attempt(np.float32(quantile), 0), attempt,
                    num_samples=num_samples, max_clusters=max_clusters,
                    retry_factor=retry_factor)


@dataclass
class ClusterPending:
    """What `cluster_batch_async` leaves for `cluster_batch_finalize`."""
    x: torch.Tensor             # (B, N, K1's and K3's width) unit rows
    width: int                  # their true width E
    shifted: torch.Tensor       # (B, N, the same width) after the shifts
    bandwidth: torch.Tensor     # (B,) on the device
    sels: list                  # per shape, the subsamples of each attempt
    generator: object           # draws the retries' subsamples
    # () int32 on the device: the steps launched after the tol exit,
    # counted only where a profiler ran when the steps were launched
    steps_after_exit: torch.Tensor | None = None


def cluster_batch_async(x, *, num_samples: int = 10000, quantile=0.015,
                        iterations: int = 50, bf16: bool = False,
                        tol: float = DEFAULT_MS_TOL, generator=None,
                        sels=None) -> ClusterPending:
    """The device half of `cluster_batch`: one bandwidth per shape (K1)
    and the shift steps of every shape in one launch each (K2b, bf16 tile
    inputs under bf16=True), with the batch-global tol exit held on the
    device (`_iterate_on_device`). Launches only; reads nothing back to the
    host."""
    b = x.shape[0]
    e = x.shape[-1]
    x = kernel_width(x)
    sels = [s if isinstance(s, (list, tuple)) else [s]
            for s in (sels if sels is not None else [None] * b)]
    bw = torch.stack([torch.clamp_min(compute_bandwidth(
        x[i], num_samples, np.float32(quantile), generator=generator,
        sel=sels[i][0]), _MIN_BANDWIDTH) for i in range(b)])
    start, cols = _step_inputs(x, e, bf16)
    after = (torch.zeros((), dtype=torch.int32, device=x.device)
             if tracing_on() else None)
    shifted = _to_width(_iterate_on_device(
        lambda cur: mean_shift_step_batched(cur, cols, bw, bf16=bf16), start,
        iterations, tol, after), x.shape[-1])
    return ClusterPending(x, e, shifted, bw, sels, generator, after)


def cluster_batch_finalize(pending: ClusterPending, *,
                           num_samples: int = 10000, quantile=0.015,
                           iterations: int = 50, max_clusters: int = 49,
                           retry_factor: float = 1.2, bf16: bool = False,
                           tol: float = DEFAULT_MS_TOL):
    """The host half of `cluster_batch`: the bandwidths read back, NMS of
    every shape (K3) with one read of the cluster counts, and a guarded
    retry (K1, K2, K3) for each shape with more than max_clusters
    clusters. Pass the clustering settings of the `cluster_batch_async`
    call that made `pending`."""
    x, shifted = pending.x, pending.shifted
    b = x.shape[0]
    bw_host = pending.bandwidth.tolist()
    if pending.steps_after_exit is not None:
        count("cluster/ms_steps_run", iterations)
        count("cluster/ms_steps_needed",
              iterations - int(pending.steps_after_exit))
    found = [nms_device(shifted[i], x[i], bw_host[i]) for i in range(b)]
    nums = np.asarray(torch.stack([f[2] for f in found]).tolist(), np.int64)
    labels = [f[0] for f in found]
    capped = np.zeros((b,), bool)
    bw_capped = np.zeros((b,), bool)
    retries = 0
    for i in np.nonzero(nums > max_clusters)[0]:
        first = MeanShiftResult(shifted[i], labels[i], found[i][1],
                                int(nums[i]), bw_host[i],
                                np.float32(quantile))
        attempt = _attempts(x[i], pending.sels[i], num_samples=num_samples,
                            iterations=iterations, tol=tol,
                            generator=pending.generator, bf16=bf16,
                            width=pending.width)
        res = _guarded(x[i], pending.width, first, attempt,
                       num_samples=num_samples, max_clusters=max_clusters,
                       retry_factor=retry_factor)
        labels[i], nums[i] = res.labels, res.num_clusters
        capped[i], bw_capped[i] = res.capped, res.bw_capped
        retries += res.tries
    count("cluster/guard_retries", retries)
    return (torch.stack(labels), torch.as_tensor(nums),
            {"capped": capped, "bw_capped": bw_capped})


def cluster_batch(x, *, num_samples: int = 10000, quantile=0.015,
                  iterations: int = 50, max_clusters: int = 49,
                  retry_factor: float = 1.2, bf16: bool = False,
                  tol: float = DEFAULT_MS_TOL, generator=None, sels=None):
    """Cluster a batch x (B, N, E): one bandwidth per shape, the shift
    steps of every shape in one launch (K2b) with a batch-global tol exit,
    per-shape NMS, and a guarded retry only for shapes with more than
    max_clusters clusters (`cluster_batch_async`, then
    `cluster_batch_finalize`).

    sels: optional subsample indices per shape, a tensor or a list with
    one per attempt (the first for the batch pass, the rest for the
    retries). The batch pass is a shape's try 0: its retries start at
    quantile * retry_factor in float32 and stop after _MAX_RETRIES in all,
    as the JAX package's per-shape guard counts them from the base
    quantile.

    Returns (labels (B, N) int64, num_clusters (B,) int64, flags) with
    flags {"capped", "bw_capped"} as (B,) bool arrays."""
    pending = cluster_batch_async(x, num_samples=num_samples,
                                  quantile=quantile, iterations=iterations,
                                  bf16=bf16, tol=tol, generator=generator,
                                  sels=sels)
    return cluster_batch_finalize(pending, num_samples=num_samples,
                                  quantile=quantile, iterations=iterations,
                                  max_clusters=max_clusters,
                                  retry_factor=retry_factor, bf16=bf16,
                                  tol=tol)
