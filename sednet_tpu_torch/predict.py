"""The headline inference path: SEDNet forward plus guarded mean-shift.

Counterpart of `bench.py:157-182` (`forward`, `cluster_one`, `pipeline`)
and `sednet_tpu/predict.py:50-66`: a batch of clouds (xyz + normals) goes
through the `inst` model, its embeddings are L2-normalised, every shape is
clustered with `guard_mean_shift` under the `ms_*` fields of a Config
(`HEADLINE`: 5000 samples, quantile 0.015, 50 iterations, tol 1e-6, at
most 49 clusters), and the types are the argmax of the type head.
"""
from __future__ import annotations

import numpy as np
import torch

from sednet_tpu_torch.cluster.mean_shift import guard_mean_shift
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.data import (EVAL_STREAM_SEED, make_synthetic_shape,
                                   normalize_points, pca_align)
from sednet_tpu_torch.weights import load_npz

# bench.py:173 clusters with 5000 samples; the rest are Config's defaults
HEADLINE = Config(ms_num_samples=5000)


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
