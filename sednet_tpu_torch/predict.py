"""Inference: the headline pipeline and the reference-default eval.

Counterpart of `bench.py:157-182` and `sednet_tpu/predict.py:50-537`:

  * `segment_batch`, the headline: the `inst` forward, L2-normalised
    embeddings, guarded mean-shift per shape under the `ms_*` fields of a
    Config (`HEADLINE`: 5000 samples, quantile 0.015, 50 iterations, tol
    1e-6, at most 49 clusters), types from the argmax of the type head;
  * `predict_shapes`, the reference-default eval: the type model's
    test-time-augmented log-probs (`make_tta_type_log_prob`), the `inst`
    forward (`make_forward`; through the fused encoder, kernel K4, with
    `cfg.fused_encoder`), HPNet spectral enrichment of the raw embedding
    per shape (`spectral_embed`, `hpnet_process`), `cluster_batch` (kernel
    K2b, batch-global tol exit, guarded retries per shape) and the
    Hungarian/chamfer-recall metrics.

The JAX package's async/finalize split of `predict_shapes` is one call
here. Its random inputs (the LOBPCG start block and the bandwidth
subsamples of each shape) come from a `torch.Generator`, or are injected
(`x0s`, `sels`) by the tests. Its stages run inside
`torch.profiler.record_function` ranges named `STAGES`, so that a profile
of one call gives each stage's host and device time.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

from sednet_tpu_torch.cluster.mean_shift import cluster_batch, guard_mean_shift
from sednet_tpu_torch.cluster.spectral import (_entropy_weighted_concat,
                                               compute_entropy,
                                               matfree_matvec,
                                               normal_affinity_topk,
                                               top_eigvecs)
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.data import (EVAL_STREAM_SEED, make_synthetic_shape,
                                   normalize_points, pca_align)
from sednet_tpu_torch.metrics import siou_matched_segments_usecd_batch
from sednet_tpu_torch.models.sednet import apply_fused
from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals
from sednet_tpu_torch.weights import load_npz

# bench.py:173 clusters with 5000 samples; the rest are Config's defaults
HEADLINE = Config(ms_num_samples=5000)

# the record_function ranges of predict_shapes, in the order they run
STAGES = tuple(f"predict_shapes/{s}" for s in (
    "type_forward", "inst_forward", "affinity", "lobpcg", "entropy_concat",
    "cluster_batch", "metrics"))


def cluster_settings(cfg: Config, n: int) -> dict:
    """guard_mean_shift's keywords for clouds of n points, from cfg's ms_*
    fields as `sednet_tpu/predict.py:386-390` passes them."""
    return {"num_samples": min(cfg.ms_num_samples, n),
            "quantile": cfg.ms_quantile, "iterations": cfg.ms_iterations,
            "max_clusters": cfg.ms_max_clusters - 1,
            "retry_factor": cfg.ms_retry_factor, "tol": cfg.ms_tol}


def load_models(npz: str, cfg: Config | None = None, device=None,
                which=("inst", "type")) -> dict:
    """{name: SEDNet} for each model `which` of a flat checkpoint."""
    return {w: load_npz(npz, w, cfg, device) for w in which}


@torch.no_grad()
def forward(model, x):
    """x: (B, N, C) -> (unit embedding (B, N, E), type log-prob
    (B, N, T), edge logits (B, N, 2))."""
    out = model(x)
    emb = out.embedding / torch.clamp_min(
        out.embedding.norm(dim=-1, keepdim=True), 1e-12)
    return emb, out.type_log_prob, out.edge_logits


@torch.no_grad()
def segment_batch(model, x, generator=None, *, cfg: Config = HEADLINE,
                  sel=None):
    """The headline pipeline on a batch x (B, N, 6) on the model's device,
    clustered under cfg's ms_* fields (sel: optional subsample indices for
    every shape, see `guard_mean_shift`).
    Returns (labels (B, N) int64, types (B, N) int64)."""
    emb, type_lp, _ = forward(model, x)
    kw = cluster_settings(cfg, x.shape[1])
    labels = [guard_mean_shift(emb[i], generator=generator, sel=sel,
                               **kw).labels
              for i in range(x.shape[0])]
    return torch.stack(labels), type_lp.argmax(-1)


def headline_shapes(n_shapes: int = 8, n_points: int = 10000,
                    seed: int = EVAL_STREAM_SEED):
    """The eval shapes of `bench.py:_shapes`: 6 segments each, normalised
    and PCA-aligned, from the reserved eval stream. Returns (shapes,
    x (B, N, 6) float32 numpy)."""
    rng = np.random.RandomState(seed)
    shapes = []
    for _ in range(n_shapes):
        d = make_synthetic_shape(rng, n_points=n_points, n_segments=6)
        pts = normalize_points(d["points"])
        pts, nrm, _ = pca_align(pts, d["normals"])
        shapes.append({**d, "points": pts.astype(np.float32),
                       "normals": nrm.astype(np.float32)})
    x = np.stack([np.concatenate([s["points"], s["normals"]], -1)
                  for s in shapes]).astype(np.float32)
    return shapes, x


Y_FLIP = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)


def make_first_layer_idx(cfg: Config):
    """The first-layer kNN graph of the model: points_normals when
    cfg.normals (mode 5), sqdist on xyz otherwise."""
    if cfg.normals:
        return lambda x: knn_indices_points_normals(
            x, cfg.knn, normal_metric_w=cfg.normal_metric_W)
    return lambda x: knn_indices(x, cfg.knn)


def make_forward(model, fused: bool = False):
    """fn(x, idx1=None) -> (type log-prob, embedding, edge logits) of
    `model`; fused=True runs the encoder through `apply_fused` (kernel K4),
    which builds no graph and ignores idx1."""
    @torch.no_grad()
    def fn(x, idx1=None):
        out = apply_fused(model, x) if fused else model(x, idx1)
        return out.type_log_prob, out.embedding, out.edge_logits

    return fn


def make_tta_type_log_prob(model, cfg: Config, multi_vote: bool,
                           fold5drop: bool, drop_num: int = 2000):
    """fn(x (B, N, C), idx1=None) -> (B, N, T) type log-probs with the test-
    time augmentation asked for (reference:
    generate_predictions_aug.py:238-362):

      * multi_vote: mean over x, xyz * 1.15 and xyz * 0.85;
      * fold5drop: the base log-probs plus, for each of the N // drop_num
        contiguous folds, the log-probs of the cloud without that fold,
        added back at the surviving points;
      * both: the fold5drop sum for x and for its y-flip rotation
        diag(-1, 1, -1) (normals rotate too), added.

    Scale and rotation votes reuse the first-layer graph (both metrics
    scale uniformly, so the order of neighbours holds); fold votes build
    their own graphs."""
    first_layer_idx = make_first_layer_idx(cfg)

    def base(x, idx1=None):
        return model(x, idx1).type_log_prob

    def fold5(x):
        n = x.shape[1]
        folds = n // drop_num
        if folds < 1:
            return 0.0
        votes = None
        for i in range(folds):
            keep = torch.cat([torch.arange(0, i * drop_num),
                              torch.arange((i + 1) * drop_num, n)]
                             ).to(x.device)
            lp = base(x[:, keep].contiguous())
            if votes is None:
                votes = torch.zeros((x.shape[0], n, lp.shape[-1]),
                                    dtype=lp.dtype, device=x.device)
            votes[:, keep] += lp
        return votes

    @torch.no_grad()
    def fn(x, idx1=None):
        if multi_vote and not fold5drop:
            idx1 = first_layer_idx(x) if idx1 is None else idx1
            big = torch.cat([x[..., :3] * 1.15, x[..., 3:]], -1)
            small = torch.cat([x[..., :3] * 0.85, x[..., 3:]], -1)
            return (base(x, idx1) + base(big, idx1) + base(small, idx1)) / 3.0
        if fold5drop and not multi_vote:
            return base(x, idx1) + fold5(x)
        if fold5drop and multi_vote:
            idx1 = first_layer_idx(x) if idx1 is None else idx1
            total = None
            for rot in (np.eye(3, dtype=np.float32), Y_FLIP):
                r = torch.from_numpy(rot).to(x.device)
                parts = [x[..., :3] @ r]
                if x.shape[-1] > 3:
                    parts.append(x[..., 3:] @ r)
                xr = torch.cat(parts, -1).contiguous()
                cur = base(xr, idx1) + fold5(xr)
                total = cur if total is None else total + cur
            return total
        return base(x, idx1)

    return fn


class SpectralCache:
    """Per-shape eigenvector cache on disk (reference:
    smooth_normal_matrix.py:189-202), one .npz per shape id under `root`."""

    def __init__(self, root: str, sigma: float, knn: int):
        self.root, self.sigma, self.knn = root, sigma, knn
        os.makedirs(root, exist_ok=True)

    def path(self, shape_id) -> str:
        return os.path.join(self.root,
                            f"Us_{shape_id}_{self.sigma}_{self.knn}.npz")

    def get(self, shape_id, device="cpu"):
        p = self.path(shape_id)
        if not os.path.exists(p):
            return None
        with np.load(p) as d:
            return (torch.from_numpy(d["v"]).to(device),
                    torch.from_numpy(d["ent"]).to(device))

    def put(self, shape_id, v, ent):
        np.savez(self.path(shape_id), v=v.cpu().numpy(),
                 ent=ent.cpu().numpy())


def spectral_embed(xyz, normals, cfg: Config, shape_id=None,
                   cache: SpectralCache | None = None, x0=None,
                   generator=None):
    """One shape's eigenvectors (N, spectral_eigvecs) and their entropy,
    from the cache when it has them. cfg.spectral_matfree None is the JAX
    package's auto policy: the dense affinity up to
    cfg.spectral_dense_max_n points, the matrix-free operator
    (`matfree_matvec`, transpose_mode "scatter") beyond. The `affinity`
    range holds the affinity (and the matrix-free layout), `lobpcg` the
    solve, on either path."""
    if cache is not None and shape_id is not None:
        cached = cache.get(shape_id, xyz.device)
        if cached is not None:
            return cached
    matfree = cfg.spectral_matfree
    if matfree is None:
        matfree = xyz.shape[0] > cfg.spectral_dense_max_n
    with record_function("predict_shapes/affinity"):
        if matfree:
            op = matfree_matvec(xyz, normals, sigma=cfg.spectral_sigma,
                                knn=cfg.spectral_knn)
        else:
            op = normal_affinity_topk(xyz, normals, sigma=cfg.spectral_sigma,
                                      k=cfg.spectral_knn)
    with record_function("predict_shapes/lobpcg"):
        v = top_eigvecs(op, xyz.shape[0], xyz.device, x0, generator,
                        k=cfg.spectral_eigvecs)
    del op
    with record_function("predict_shapes/entropy_concat"):
        ent = compute_entropy(v)
    if cache is not None and shape_id is not None:
        cache.put(shape_id, v, ent)
    return v, ent


def enrich_embedding(embedding, xyz, normals, cfg: Config, *, shape_id=None,
                     cache: SpectralCache | None = None, x0=None,
                     generator=None):
    """One shape's clustering embedding under cfg.hpnet_embed: the raw
    embedding (N, K) and the shape's eigenvectors (`spectral_embed`),
    entropy-weighted and concatenated by `hpnet_process`, rows
    L2-normalised (N, K + spectral_eigvecs) (`sednet_tpu/predict.py:
    346-365`)."""
    v, ent = spectral_embed(xyz, normals, cfg, shape_id=shape_id,
                            cache=cache, x0=x0, generator=generator)
    with record_function("predict_shapes/entropy_concat"):
        return _entropy_weighted_concat(embedding, v, cfg.normal_smooth_w,
                                        ent)


@torch.no_grad()
def predict_shapes(model_type, model_inst, batch: dict, cfg: Config, *,
                   generator=None, multi_vote: bool = False,
                   fold5drop: bool = False,
                   cache: SpectralCache | None = None, shape_ids=None,
                   tta_fn=None, forward_fn=None, x0s=None, sels=None):
    """The reference-default eval of a batch (see the module docstring).

    batch: numpy "points", "normals" (B, N, 3), "labels", "prim" (B, N).
    The models' device runs everything but the Hungarian assignment.
    Pass tta_fn / forward_fn to reuse them across calls; x0s / sels inject
    each shape's LOBPCG start block and bandwidth subsamples (a tensor, or
    one per clustering attempt). Returns one dict per shape: cluster_ids,
    pred_primitives, edge_prob, inst_iou, type_iou, inst_recall,
    num_clusters, guard_capped, guard_bw_capped."""
    dev = next(model_inst.parameters()).device
    pts = np.asarray(batch["points"], np.float32)
    nrm_np = np.asarray(batch["normals"], np.float32)
    x = np.concatenate([pts, nrm_np], -1) if cfg.normals else pts
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if tta_fn is None:
        tta_fn = make_tta_type_log_prob(model_type, cfg, multi_vote,
                                        fold5drop)
    if forward_fn is None:
        forward_fn = make_forward(model_inst, fused=cfg.fused_encoder)
    # one first-layer graph serves the type votes and the inst forward,
    # unless the fused encoder runs (it builds none)
    with record_function("predict_shapes/type_forward"):
        idx1 = None if cfg.fused_encoder else make_first_layer_idx(cfg)(x)
        type_lp = tta_fn(x, idx1)
    with record_function("predict_shapes/inst_forward"):
        _, embedding, edge_logits = forward_fn(x, idx1)

    b = x.shape[0]
    xyz = x[..., :3]
    nrm = x[..., 3:6] if x.shape[-1] >= 6 else torch.from_numpy(nrm_np).to(dev)
    if cfg.hpnet_embed:
        emb_n = torch.stack([enrich_embedding(
            embedding[i], xyz[i], nrm[i], cfg,
            shape_id=shape_ids[i] if shape_ids is not None else None,
            cache=cache, x0=x0s[i] if x0s is not None else None,
            generator=generator) for i in range(b)])
    else:
        emb_n = embedding / torch.clamp_min(
            torch.linalg.vector_norm(embedding, dim=-1, keepdim=True), 1e-12)

    with record_function("predict_shapes/cluster_batch"):
        labels, nums, flags = cluster_batch(
            emb_n.contiguous(), generator=generator, sels=sels,
            **cluster_settings(cfg, cfg.num_points))
        labels_np = labels.cpu().numpy()
    pred_prim = type_lp.argmax(-1).cpu().numpy()
    edge_prob = (torch.softmax(edge_logits, -1).cpu().numpy()
                 if edge_logits is not None else
                 np.zeros(pred_prim.shape + (2,), np.float32))
    with record_function("predict_shapes/metrics"):
        mets = siou_matched_segments_usecd_batch(
            [np.asarray(t).astype(np.int64) for t in batch["labels"]],
            list(labels_np), list(pred_prim),
            [np.asarray(p).astype(np.int64) for p in batch["prim"]],
            list(pts), device=dev)
    return [{"cluster_ids": labels_np[i],
             "pred_primitives": pred_prim[i],
             "edge_prob": edge_prob[i],
             "inst_iou": mets[i][0], "type_iou": mets[i][1],
             "inst_recall": mets[i][4],
             "num_clusters": int(nums[i]),
             "guard_capped": bool(flags["capped"][i]),
             "guard_bw_capped": bool(flags["bw_capped"][i])}
            for i in range(b)]
