"""HPNet-style spectral enrichment of the instance embedding.

Counterpart of `sednet_tpu/cluster/spectral.py` (reference:
src/smooth_normal_matrix.py): a normal-angle affinity over a k-neighbourhood,
its top eigenvectors by LOBPCG (`cluster/lobpcg.py`), pairwise-distance
entropies, and the entropy-weighted concatenation [embedding, eigenvectors].

Reference quirk kept: the reference's knn_idx takes torch.topk of positive
squared distances with largest=True, so the "neighbourhood" is the k
FARTHEST points (`nearest=False`, the default). On the card the k farthest
come from kernel K1 with `largest=True`, as the TPU branch does.

Two solvers, as in the JAX package:

  * dense (`normal_affinity_topk`, `spectral_eigvecs`): the N x N float32
    affinity, up to `spectral_dense_max_n` points;
  * matrix-free (`normal_affinity_sparse`, `spectral_eigvecs_matfree`):
    the N * k entries only, for larger clouds. A v is one gather over the
    entries; A^T v has the five layouts of `transpose_mode`, one of which
    ("pallas") runs kernel K5 (`ops.cuda_kernels.segsum_sorted_scan`).
"""
from __future__ import annotations

import math

import torch

from sednet_tpu_torch.cluster.lobpcg import lobpcg_standard
from sednet_tpu_torch.ops.cuda_kernels import (segsum_sorted_scan,
                                               segsum_sorted_scan_plain)
from sednet_tpu_torch.ops.flash_topk import flash_topk
from sednet_tpu_torch.ops.knn import pairwise_sqdist
from sednet_tpu_torch.utils.tracing import count

TRANSPOSE_MODES = ("scatter", "sorted", "scan", "pallas", "vocab")


def _neighbor_idx(xyz, k: int, nearest: bool):
    """(N, 3) -> (N, k) int64 neighbour indices, the k farthest by default
    (see the module docstring), through K1 (its plain version on the CPU).
    The order among equal distances may differ from the JAX package's, as it
    may between the reference's backends; an exact tie swaps equal weights."""
    return flash_topk(xyz.contiguous(), xyz.contiguous(), k,
                      largest=not nearest)


def normal_affinity_topk(xyz, normals, *, sigma: float = 0.1, k: int = 50,
                         nearest: bool = False):
    """Symmetric normalised normal-angle affinity (N, N) float32
    (reference: src/smooth_normal_matrix.py:42-92), with the JAX package's
    bookkeeping of the reference's 1e-12 background fill:

      * weights that underflow to 0 are set to 1e-12 (the fill would);
      * d_i = rsqrt(sum_k w + 1e-12 (N - k)), the filled row sum;
      * entries 1e-12 + h_ij + h_ji with h = (w - 1e-12) / 2 on the kNN
        pairs, the reference's (A + A^T) / 2 of the filled matrix;
      * A * (d_i d_j), the outer product first so A stays symmetric.

    The JAX package sums each entry as (1e-12 + first term) + second term,
    in neighbour-slot order; here it is (h_ij + h_ji) + 1e-12, so an entry
    with two hits may differ in its last bit (about 1 ulp of w)."""
    n = xyz.shape[0]
    idx = _neighbor_idx(xyz, k, nearest)
    cos = torch.clamp(torch.einsum("nc,nkc->nk", normals, normals[idx]),
                      -0.99, 0.99)
    w = torch.exp(-torch.arccos(cos) ** 2 / (2.0 * sigma * sigma))
    w = torch.where(w == 0.0, 1e-12, w)
    d = torch.rsqrt(w.sum(-1) + 1e-12 * (n - k))
    a = torch.zeros((n, n), dtype=torch.float32, device=xyz.device)
    rows = torch.arange(n, device=xyz.device)[:, None].expand(-1, k)
    a[rows, idx] = (w - 1e-12) * 0.5    # kNN rows are distinct: no collision
    a = a + a.T
    a += 1e-12
    a *= d[:, None] * d[None, :]
    return a


def compute_entropy(feat, *, row_block: int = 1024):
    """Pairwise-distance entropy of a feature set (N, K) (reference:
    src/smooth_normal_matrix.py:95-154): per-channel range normalisation,
    mean pairwise distance, alpha = ln 2 / mean, then the mean binary
    entropy of s = exp(-alpha d). Two row-blocked passes; no N x N."""
    n = feat.shape[0]
    interval = feat.max(0).values - feat.min(0).values
    g = feat / torch.where(interval == 0, 1.0, interval)

    def block_dist(r0):
        return torch.sqrt(torch.clamp_min(
            pairwise_sqdist(g[r0:r0 + row_block], g), 0.0))

    starts = range(0, n, row_block)
    total = sum(block_dist(r0).sum() for r0 in starts)
    alpha = -math.log(0.5) / (total / (n * n))
    eps = 1e-7

    def block_ent(r0):
        s = torch.exp(-alpha * block_dist(r0))
        return (-s * torch.log(s + eps)
                - (1 - s) * torch.log(1 - s + eps)).sum()

    return sum(block_ent(r0) for r0 in starts) / (n * n)


def top_eigvecs(a, n: int, device, x0=None, generator=None, k: int = 12,
                iters: int = 10):
    """Top-k eigenvectors of the symmetric operator `a` (an (n, n) tensor or
    a callable v -> a @ v) by LOBPCG (`iters` iterations), each row
    L2-normalised with + 1e-16 (reference: src/smooth_normal_matrix.py:
    198-199). x0: the (n, k) start block, standard normal from `generator`
    when not given (the tests inject JAX's). While a profiler runs, the
    iterations the solve took are the count `lobpcg/iterations`."""
    if x0 is None:
        x0 = torch.randn((n, k), generator=generator, dtype=torch.float32)
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(device)
    _, u, its = lobpcg_standard(a, x0, m=iters)
    count("lobpcg/iterations", its)
    return u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-16)


def spectral_eigvecs(affinity, x0=None, generator=None, k: int = 12,
                     iters: int = 10):
    """Top-k eigenvectors of the dense affinity (`top_eigvecs`)."""
    return top_eigvecs(affinity, affinity.shape[0], affinity.device, x0,
                       generator, k, iters)


def normal_affinity_sparse(xyz, normals, *, sigma: float = 0.1, k: int = 50,
                           nearest: bool = False, idx=None):
    """Sparse form of the affinity: (idx (N, k), w (N, k), rsqrt_deg (N,))
    with A = D^-1/2 W D^-1/2, W the scatter of w at (row, idx), and the
    operator (A + A^T) / 2. None of the dense path's 1e-12 background fill:
    deg = max(sum_k w, 1e-12), so rsqrt_deg spans about 1e6 where farthest
    weights underflow. Pass `idx` to skip the neighbour search (K1)."""
    if idx is None:
        idx = _neighbor_idx(xyz, k, nearest)
    cos = torch.clamp(torch.einsum("nc,nkc->nk", normals, normals[idx]),
                      -0.99, 0.99)
    w = torch.exp(-torch.arccos(cos) ** 2 / (2.0 * sigma * sigma))
    deg = torch.clamp_min(w.sum(-1), 1e-12)
    return idx, w, torch.rsqrt(deg)


def default_transpose_mode(vmapped: bool = False) -> str:
    """The JAX package's preferred A^T v layout: "vocab" for one shape,
    "scatter" for callers that batch the solve over shapes (there a
    vocabulary overflow would make every shape pay both formulations).
    The port keeps the same answer; `predict` uses "scatter", as the JAX
    package's `spectral_embed` does."""
    return "scatter" if vmapped else "vocab"


def _sorted_transpose_layout(idx, coef):
    """Once-per-operator layout of A^T v: the entries e = (row j, slot kk),
    with destination idx[j, kk] and coefficient coef[j, kk], sorted by
    destination with a stable sort (the order inside a segment is the
    order of its sum); per-destination END offsets are the cumsum of a
    bincount. Returns (src (E,) int64, coef_sorted (E,), dest_sorted (E,)
    int32, ends (N,) int32)."""
    n, k = idx.shape
    dest = idx.reshape(-1)
    order = torch.argsort(dest, stable=True)
    src = torch.arange(n, device=idx.device).repeat_interleave(k)[order]
    counts = torch.bincount(dest, minlength=n)
    return (src, coef.reshape(-1)[order], dest[order].to(torch.int32),
            torch.cumsum(counts, 0).to(torch.int32))


def _segment_sum_sorted_scan(vals, dest, n: int, ends):
    """Segment sums of the rows of vals (E, m) grouped by sorted `dest`, by
    the segmented inclusive scan (ceil(log2 E) shift and masked-add passes,
    no scatter, no cumsum difference): the JAX package's name and (E, m)
    layout for K5's plain version (`segsum_sorted_scan_plain`), which the
    "scan" matvec calls on the (m, E) entries directly. Returns (n, m), 0
    for empty destinations."""
    return segsum_sorted_scan_plain(vals.T, dest, ends)


def _default_vocab_cap(n: int) -> int:
    """Column capacity of the "vocab" layout: the farthest-50 graph's
    distinct targets are a property of the geometry (a few hundred on CAD
    shapes, whatever N), so the cap is clamped at 2048."""
    return min(2048, max(512, -(-(n // 8) // 128) * 128))


def _vocab_layout(idx, coef, n: int, u_cap: int):
    """Compact-column layout of A for transpose_mode="vocab": the distinct
    targets of the graph (ascending; pad slots hold n) and the dense
    (N, u_cap) slab A_c[i, u] = coef[i, slot] where idx[i, slot] ==
    targets[u], so that A v = A_c @ v[targets] and A^T v = scatter of
    A_c^T v at targets. Returns (targets (u_cap,) int64, a_c, n_unique as
    a 0-d tensor). Targets past the cap are dropped."""
    flat = torch.sort(idx.reshape(-1)).values
    is_new = torch.ones_like(flat)
    is_new[1:] = (flat[1:] != flat[:-1]).to(flat.dtype)
    rank = torch.cumsum(is_new, 0) - 1
    keep = rank < u_cap
    targets = torch.full((u_cap,), n, dtype=torch.int64, device=idx.device)
    targets[rank[keep]] = flat[keep]
    lut = torch.zeros((n,), dtype=torch.int64, device=idx.device)
    lut[flat] = rank
    cols = lut[idx]
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    rows = rows.expand_as(idx)
    ok = cols < u_cap
    a_c = torch.zeros((idx.shape[0], u_cap), dtype=torch.float32,
                      device=idx.device)
    a_c.index_put_((rows[ok], cols[ok]), coef[ok], accumulate=True)
    return targets, a_c, rank[-1] + 1


def _scatter_matvec(idx, coef):
    """The per-edge form of (A + A^T) v / 2: a gather for A v, index_add_
    for A^T v."""
    flat = idx.reshape(-1)

    def matvec(v):
        av = (v[idx] * coef[..., None]).sum(1)
        contrib = (coef[..., None] * v[:, None, :]).reshape(-1, v.shape[1])
        return 0.5 * (av + torch.zeros_like(v).index_add_(0, flat, contrib))

    return matvec


def _vocab_matvec(idx, coef, n: int, u_cap: int):
    """(A + A^T) v / 2 through the compact slab (`_vocab_layout`): both
    directions are float32 matmuls (TF32 is off in the package) plus a
    gather and a scatter of u_cap rows. Where the graph has more distinct
    targets than u_cap, the per-edge scatter form instead: the JAX
    package's lax.cond is a host `if` here, one sync per operator."""
    targets, a_c, n_unique = _vocab_layout(idx, coef, n, u_cap)
    n_unique = int(n_unique)
    if n_unique > u_cap:
        return _scatter_matvec(idx, coef)
    t_valid = (targets < n)[:, None]
    t_safe = torch.clamp_max(targets, n - 1)
    hits = targets[:n_unique]

    def matvec(v):
        av = a_c @ torch.where(t_valid, v[t_safe], 0.0)
        atc = a_c.T @ v
        atv = torch.zeros_like(v).index_add_(0, hits, atc[:n_unique])
        return 0.5 * (av + atv)

    return matvec


def matfree_matvec(xyz, normals, *, sigma: float = 0.1, knn: int = 50,
                   idx=None, transpose_mode: str = "scatter",
                   vocab_cap: int | None = None):
    """The operator v (N, m) -> (A + A^T) v / 2 of the sparse affinity
    (`normal_affinity_sparse`), built once: the affinity, the entry
    coefficients coef = rsq_i w_ij rsq_j and the layout of the mode. A v is
    one gather; A^T v by transpose_mode:

      "scatter"  index_add_ of the entries at their destinations;
      "sorted"   index_add_ on the entries sorted by destination
                 (`_sorted_transpose_layout`), XLA's segment_sum there;
      "scan"     the segmented scan (`segsum_sorted_scan_plain`) on the
                 transposed sorted entries vals_t = coef_s * v.T[:, src_s]
                 (m, E);
      "pallas"   kernel K5 (`segsum_sorted_scan`) on the same vals_t: the
                 JAX name, which there means the Pallas kernel and here K5;
      "vocab"    the compact-column slab (`_vocab_matvec`).

    "scatter" and "sorted" add through atomics on the card (last-ulp
    order varies); "scan", "pallas" and "vocab" are deterministic."""
    if transpose_mode not in TRANSPOSE_MODES:
        raise ValueError(f"unknown transpose_mode {transpose_mode!r}")
    n = xyz.shape[0]
    idx, w, rsq = normal_affinity_sparse(xyz, normals, sigma=sigma, k=knn,
                                         idx=idx)
    coef = w * rsq[idx] * rsq[:, None]
    if transpose_mode == "vocab":
        return _vocab_matvec(idx, coef, n, vocab_cap or _default_vocab_cap(n))
    if transpose_mode == "scatter":
        return _scatter_matvec(idx, coef)
    src_s, coef_s, dest_s, ends_s = _sorted_transpose_layout(idx, coef)

    segsum = {"scan": segsum_sorted_scan_plain,
              "pallas": segsum_sorted_scan}.get(transpose_mode)

    def transpose(v):
        if transpose_mode == "sorted":
            return torch.zeros_like(v).index_add_(0, dest_s,
                                                  coef_s[:, None] * v[src_s])
        vals_t = coef_s[None, :] * torch.index_select(v.T.contiguous(), 1,
                                                      src_s)
        return segsum(vals_t, dest_s, ends_s)

    def matvec(v):
        av = (v[idx] * coef[..., None]).sum(1)
        return 0.5 * (av + transpose(v))

    return matvec


def spectral_eigvecs_matfree(xyz, normals, x0=None, generator=None, *,
                             sigma: float = 0.1, knn: int = 50, k: int = 12,
                             iters: int = 10, idx=None,
                             transpose_mode: str = "scatter",
                             vocab_cap: int | None = None):
    """Top-k eigenvectors of the sparse affinity by LOBPCG on the
    matrix-free operator (`matfree_matvec`), rows L2-normalised: the N x N
    matrix never exists. x0 / generator: the start block, as in
    `top_eigvecs`."""
    matvec = matfree_matvec(xyz, normals, sigma=sigma, knn=knn, idx=idx,
                            transpose_mode=transpose_mode,
                            vocab_cap=vocab_cap)
    return top_eigvecs(matvec, xyz.shape[0], xyz.device, x0, generator, k,
                       iters)


def hpnet_process(embedding, xyz, normals, *, type_log_prob=None,
                  edge_logits=None, normal_smooth_w: float = 0.5,
                  sigma: float = 0.1, knn: int = 50, eig_k: int = 12,
                  x0=None, generator=None, cached_eigvecs=None,
                  cached_eig_entropy=None):
    """Entropy-weighted concat of [embedding, normal-spectral eigenvectors,
    type (+ edge) probabilities] (reference:
    src/smooth_normal_matrix.py:157-232). embedding: (N, K), not
    normalised. cached_eigvecs / cached_eig_entropy reuse an earlier
    solve (`predict.SpectralCache`)."""
    parts = [embedding]
    weights = [1.7 - compute_entropy(embedding)]
    if cached_eigvecs is None:
        aff = normal_affinity_topk(xyz, normals, sigma=sigma, k=knn)
        v = spectral_eigvecs(aff, x0, generator, k=eig_k)
        v_ent = compute_entropy(v)
    else:
        v = cached_eigvecs
        v_ent = (cached_eig_entropy if cached_eig_entropy is not None
                 else compute_entropy(v))
    parts.append(v)
    weights.append(normal_smooth_w - v_ent)
    if type_log_prob is not None:
        t = torch.exp(type_log_prob)
        if edge_logits is not None:
            t = torch.cat([t, torch.softmax(edge_logits, -1)], -1)
        parts.append(t)
        weights.append(0.25 - compute_entropy(t))
    return torch.cat([p * w for p, w in zip(parts, weights)], -1)


def _entropy_weighted_concat(emb, v, normal_smooth_w: float, v_ent=None):
    """`hpnet_process` of [embedding, eigenvectors] with the eigenvectors
    given (v_ent: their entropy, when known), rows L2-normalised
    (generate_predictions_aug.py:371-377)."""
    e = hpnet_process(emb, None, None, normal_smooth_w=normal_smooth_w,
                      cached_eigvecs=v, cached_eig_entropy=v_ent)
    return e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1,
                                                        keepdim=True), 1e-12)


def hpnet_enrich_dense(emb, xyz, normals, *, x0=None, generator=None,
                       normal_smooth_w: float = 0.5, sigma: float = 0.1,
                       knn: int = 50, eig_k: int = 12, iters: int = 10):
    """One shape's enrichment through the dense affinity and LOBPCG, then
    the entropy-weighted concatenation, L2-normalised."""
    aff = normal_affinity_topk(xyz, normals, sigma=sigma, k=knn)
    v = spectral_eigvecs(aff, x0, generator, k=eig_k, iters=iters)
    return _entropy_weighted_concat(emb, v, normal_smooth_w)


def hpnet_enrich(emb, xyz, normals, x0=None, generator=None, *,
                 normal_smooth_w: float = 0.5, sigma: float = 0.1,
                 knn: int = 50, eig_k: int = 12, iters: int = 10, idx=None,
                 transpose_mode: str = "scatter"):
    """One shape's enrichment through the matrix-free solver
    (`spectral_eigvecs_matfree` with `transpose_mode`), then the
    entropy-weighted concatenation, L2-normalised."""
    v = spectral_eigvecs_matfree(xyz, normals, x0, generator, sigma=sigma,
                                 knn=knn, k=eig_k, iters=iters, idx=idx,
                                 transpose_mode=transpose_mode)
    return _entropy_weighted_concat(emb, v, normal_smooth_w)
