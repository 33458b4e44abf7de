"""HPNet-style spectral enrichment of the instance embedding, dense path.

Counterpart of `sednet_tpu/cluster/spectral.py:12-216,535-610` (reference:
src/smooth_normal_matrix.py): a normal-angle affinity over a k-neighbourhood,
its top eigenvectors by LOBPCG (`cluster/lobpcg.py`), pairwise-distance
entropies, and the entropy-weighted concatenation [embedding, eigenvectors].

Reference quirk kept: the reference's knn_idx takes torch.topk of positive
squared distances with largest=True, so the "neighbourhood" is the k
FARTHEST points (`nearest=False`, the default). On the card the k farthest
come from kernel K1 with `largest=True`, as the TPU branch does.

Only the dense affinity (N x N float32) is ported. The matrix-free solver,
which the JAX package takes above `spectral_dense_max_n` points or with
`spectral_matfree=True`, is not (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import math

import torch

from sednet_tpu_torch.cluster.lobpcg import lobpcg_standard
from sednet_tpu_torch.ops.flash_topk import flash_topk
from sednet_tpu_torch.ops.knn import pairwise_sqdist

MATFREE_TODO = ("the matrix-free spectral path (N > spectral_dense_max_n or "
                "spectral_matfree=True) is not ported: ROADMAP queue 1 item 7")


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


def spectral_eigvecs(affinity, x0=None, generator=None, k: int = 12,
                     iters: int = 10):
    """Top-k eigenvectors of the affinity by LOBPCG (`iters` iterations),
    each row L2-normalised (reference: src/smooth_normal_matrix.py:198-199).
    x0: the (N, k) start block, standard normal from `generator` when not
    given (the tests inject JAX's)."""
    n = affinity.shape[0]
    if x0 is None:
        x0 = torch.randn((n, k), generator=generator, dtype=torch.float32)
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(affinity.device)
    _, u, _ = lobpcg_standard(affinity, x0, m=iters)
    return u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-16)


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
