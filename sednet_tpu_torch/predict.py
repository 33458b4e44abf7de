"""Inference: the headline pipeline, the reference-default eval and the
predict CLI.

Counterpart of `bench.py:157-182` and `sednet_tpu/predict.py`:

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
    Hungarian/chamfer-recall metrics. It is `predict_shapes_finalize`
    of `predict_shapes_async`: the device half (forwards, enrichment,
    bandwidths and shift loop) reads back only what the LOBPCG solve
    reads, and the host half (NMS and the cluster counts, guarded retries,
    the transfers and the metrics) runs on a side stream that waits for
    the batch's device half alone, so that it overlaps the next batch's
    device half (`predict_shapes_stream`, `predict_loader`);
  * `run_prediction` and `main`, the CLI (`python -m
    sednet_tpu_torch.predict <cfg> [NoSave] [multi_vote] [fold5drop]
    [postproc] [--starts S] [--batch-size B] [--mesh N]`): a ParseNet- or
    Edge-schema test set (h5, read with h5py) through the double-buffered
    loop `predict_loader`, with the reference's txt dumps
    (`save_shape_outputs`) and, with `postproc`, the fitted primitives,
    intersection curves, corners and meshes (`run_postproc`).

Random inputs (each shape's LOBPCG start block, the bandwidth subsamples,
the retries' subsamples) come from one `torch.Generator` a batch
(`batch_generator`), drawn in the same order whether the halves of two
batches interleave or not, and whether a shape's eigenvectors come from
the cache or not; the tests inject them (`x0s`, `sels`). The stages run
inside spans named `STAGES` (`utils.tracing.span`: `record_function`
ranges while a profiler runs), so that a profile of one call gives each
stage's host and device time.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import logging
import os
import sys

import numpy as np
import torch

from sednet_tpu_torch.cluster.mean_shift import (cluster_batch_async,
                                                 cluster_batch_finalize,
                                                 guard_mean_shift)
from sednet_tpu_torch.cluster.spectral import (_entropy_weighted_concat,
                                               compute_entropy,
                                               matfree_matvec,
                                               normal_affinity_topk,
                                               top_eigvecs)
from sednet_tpu_torch.config import Config, load_config
from sednet_tpu_torch.data import (EVAL_STREAM_SEED, BatchLoader, EdgeDataset,
                                   ParseNetDataset, make_synthetic_shape,
                                   normalize_points, pca_align,
                                   project_types_fitting)
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.metrics import siou_matched_segments_usecd_batch
from sednet_tpu_torch.models.sednet import SEDNet, apply_fused
from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals
from sednet_tpu_torch.utils import visual_labels
from sednet_tpu_torch.utils.tracing import span
from sednet_tpu_torch.weights import load_checkpoint, load_npz

logger = logging.getLogger("sednet_tpu_torch.predict")

# bench.py:173 clusters with 5000 samples; the rest are Config's defaults
HEADLINE = Config(ms_num_samples=5000)

# the spans of predict_shapes, in the order they run
STAGES = tuple(f"predict_shapes/{s}" for s in (
    "type_forward", "inst_forward", "affinity", "lobpcg", "entropy_concat",
    "cluster_batch", "metrics"))


def cluster_settings(cfg: Config, n: int) -> dict:
    """guard_mean_shift's keywords for clouds of n points, from cfg's ms_*
    fields as `sednet_tpu/predict.py:380-383,453-457` passes them (bf16 the
    steps' tile inputs, `ms_bf16`)."""
    return {"num_samples": min(cfg.ms_num_samples, n),
            "quantile": cfg.ms_quantile, "iterations": cfg.ms_iterations,
            "max_clusters": cfg.ms_max_clusters - 1,
            "retry_factor": cfg.ms_retry_factor, "bf16": cfg.ms_bf16,
            "tol": cfg.ms_tol}


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
    with span("predict_shapes/affinity"):
        if matfree:
            op = matfree_matvec(xyz, normals, sigma=cfg.spectral_sigma,
                                knn=cfg.spectral_knn)
        else:
            op = normal_affinity_topk(xyz, normals, sigma=cfg.spectral_sigma,
                                      k=cfg.spectral_knn)
    with span("predict_shapes/lobpcg"):
        v = top_eigvecs(op, xyz.shape[0], xyz.device, x0, generator,
                        k=cfg.spectral_eigvecs)
    del op
    with span("predict_shapes/entropy_concat"):
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
    with span("predict_shapes/entropy_concat"):
        return _entropy_weighted_concat(embedding, v, cfg.normal_smooth_w,
                                        ent)


def batch_generator(seed: int, k: int | None = None) -> torch.Generator:
    """The generator of one batch's random inputs: seeded from `seed`
    alone (`run_prediction` gives every batch this one, as the JAX package
    gives every batch the same key), or from (seed, k) for batch k of
    `predict_shapes_stream` (the JAX package's fold_in(key, k))."""
    if k is not None:
        seed = int(np.random.SeedSequence((seed, k)).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


@torch.no_grad()
def predict_shapes_async(model_type, model_inst, batch: dict, cfg: Config, *,
                         generator=None, multi_vote: bool = False,
                         fold5drop: bool = False,
                         cache: SpectralCache | None = None, shape_ids=None,
                         tta_fn=None, forward_fn=None, x0s=None,
                         sels=None) -> dict:
    """The device half of `predict_shapes` (`sednet_tpu/predict.py:255`):
    the forwards, the enrichment (its LOBPCG solve reads back to the
    host), the bandwidths and the shift loop (`cluster_batch_async`, no
    host read), the type argmax and the edge softmax. Returns the pending
    dict for `predict_shapes_finalize`."""
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
    with span("predict_shapes/type_forward"):
        idx1 = None if cfg.fused_encoder else make_first_layer_idx(cfg)(x)
        type_lp = tta_fn(x, idx1)
    with span("predict_shapes/inst_forward"):
        _, embedding, edge_logits = forward_fn(x, idx1)

    b, n = x.shape[:2]
    xyz = x[..., :3]
    nrm = x[..., 3:6] if x.shape[-1] >= 6 else torch.from_numpy(nrm_np).to(dev)
    if cfg.hpnet_embed:
        embs = []
        for i in range(b):
            # drawn even when the cache holds the shape, so that the later
            # draws do not depend on the cache
            x0 = x0s[i] if x0s is not None else torch.randn(
                (n, cfg.spectral_eigvecs), generator=generator)
            embs.append(enrich_embedding(
                embedding[i], xyz[i], nrm[i], cfg, x0=x0, cache=cache,
                shape_id=shape_ids[i] if shape_ids is not None else None))
        emb_n = torch.stack(embs)
    else:
        emb_n = embedding / torch.clamp_min(
            torch.linalg.vector_norm(embedding, dim=-1, keepdim=True), 1e-12)

    kw = cluster_settings(cfg, cfg.num_points)
    with span("predict_shapes/cluster_batch"):
        clusters = cluster_batch_async(
            emb_n.contiguous(), generator=generator, sels=sels,
            num_samples=kw["num_samples"], quantile=kw["quantile"],
            iterations=kw["iterations"], bf16=kw["bf16"], tol=kw["tol"])
    pending = {"batch": batch, "cfg": cfg, "device": dev,
               "clusters": clusters,
               "pred_prim": type_lp.argmax(-1),
               "edge_prob": (torch.softmax(edge_logits, -1)
                             if edge_logits is not None else None),
               "ready": None}
    if dev.type == "cuda":
        pending["ready"] = torch.cuda.Event()
        pending["ready"].record()
    return pending


@contextlib.contextmanager
def _after(ready, device):
    """Run the block on a side stream that waits for the event `ready`
    (the end of one batch's device half) and nothing enqueued after it."""
    if ready is None:
        yield
        return
    side = torch.cuda.Stream(device=device)
    side.wait_event(ready)
    with torch.cuda.stream(side):
        yield


@torch.no_grad()
def predict_shapes_finalize(pending: dict) -> list:
    """The host half of `predict_shapes` (`sednet_tpu/predict.py:420`):
    NMS with one read of the cluster counts and the rare guarded retries
    (`cluster_batch_finalize`), the transfers and the metrics, on a side stream behind the batch's device half.
    Returns one dict per shape: cluster_ids, pred_primitives, edge_prob,
    inst_iou, type_iou, inst_recall, num_clusters, guard_capped,
    guard_bw_capped."""
    batch, cfg, dev = pending["batch"], pending["cfg"], pending["device"]
    with _after(pending["ready"], dev):
        with span("predict_shapes/cluster_batch"):
            labels, nums, flags = cluster_batch_finalize(
                pending["clusters"], **cluster_settings(cfg, cfg.num_points))
            labels_np = labels.cpu().numpy()
        pred_prim = pending["pred_prim"].cpu().numpy()
        edge_prob = (pending["edge_prob"].cpu().numpy()
                     if pending["edge_prob"] is not None else
                     np.zeros(pred_prim.shape + (2,), np.float32))
        with span("predict_shapes/metrics"):
            mets = siou_matched_segments_usecd_batch(
                [np.asarray(t).astype(np.int64) for t in batch["labels"]],
                list(labels_np), list(pred_prim),
                [np.asarray(p).astype(np.int64) for p in batch["prim"]],
                list(np.asarray(batch["points"], np.float32)), device=dev)
    return [{"cluster_ids": labels_np[i],
             "pred_primitives": pred_prim[i],
             "edge_prob": edge_prob[i],
             "inst_iou": mets[i][0], "type_iou": mets[i][1],
             "inst_recall": mets[i][4],
             "num_clusters": int(nums[i]),
             "guard_capped": bool(flags["capped"][i]),
             "guard_bw_capped": bool(flags["bw_capped"][i])}
            for i in range(len(labels_np))]


def predict_shapes(model_type, model_inst, batch: dict, cfg: Config, *,
                   generator=None, multi_vote: bool = False,
                   fold5drop: bool = False,
                   cache: SpectralCache | None = None, shape_ids=None,
                   tta_fn=None, forward_fn=None, x0s=None, sels=None):
    """The reference-default eval of a batch (see the module docstring):
    `predict_shapes_finalize(predict_shapes_async(...))`.

    batch: numpy "points", "normals" (B, N, 3), "labels", "prim" (B, N).
    The models' device runs everything but the Hungarian assignment.
    Pass tta_fn / forward_fn to reuse them across calls; x0s / sels inject
    each shape's LOBPCG start block and bandwidth subsamples (a tensor, or
    one per clustering attempt). Returns one dict per shape (see
    `predict_shapes_finalize`)."""
    return predict_shapes_finalize(predict_shapes_async(
        model_type, model_inst, batch, cfg, generator=generator,
        multi_vote=multi_vote, fold5drop=fold5drop, cache=cache,
        shape_ids=shape_ids, tta_fn=tta_fn, forward_fn=forward_fn, x0s=x0s,
        sels=sels))


def predict_shapes_stream(model_type, model_inst, batches, cfg: Config, *,
                          seed: int = 0, generators=None,
                          multi_vote: bool = False, fold5drop: bool = False,
                          cache: SpectralCache | None = None, tta_fn=None,
                          forward_fn=None):
    """Double-buffered eval over a stream of batches
    (`sednet_tpu/predict.py:540`): batch k+1's device half is enqueued
    before batch k's host half runs. Each batch's outputs equal those of
    `predict_shapes` on that batch with generator `generators(k)`, by
    default `batch_generator(seed, k)`.

    batches: an iterable of batch dicts, or of (batch dict, shape ids)
    tuples when a SpectralCache is in play. Yields one result list per
    batch, in order."""
    if generators is None:
        generators = functools.partial(batch_generator, seed)
    if tta_fn is None:
        tta_fn = make_tta_type_log_prob(model_type, cfg, multi_vote,
                                        fold5drop)
    if forward_fn is None:
        forward_fn = make_forward(model_inst, fused=cfg.fused_encoder)
    pending = None
    for k, item in enumerate(batches):
        batch_k, sids = item if isinstance(item, tuple) else (item, None)
        nxt = predict_shapes_async(
            model_type, model_inst, batch_k, cfg, generator=generators(k),
            cache=cache, shape_ids=sids, tta_fn=tta_fn, forward_fn=forward_fn)
        if pending is not None:
            yield predict_shapes_finalize(pending)
        pending = nxt
    if pending is not None:
        yield predict_shapes_finalize(pending)


def save_shape_outputs(out_dir: str, shape_id, batch_i: dict, result: dict,
                       save_gt: bool = True):
    """The txt dumps of one shape in the reference's vocabulary
    (generate_predictions_aug.py:416-437; `sednet_tpu/predict.py:585`):
    the same eight files, names, formats and delimiters, through
    np.savetxt."""
    os.makedirs(out_dir, exist_ok=True)

    def dump(name, arr, **kw):
        np.savetxt(os.path.join(out_dir, f"{shape_id}_{name}.txt"), arr, **kw)

    dump("inst", result["cluster_ids"], fmt="%d")
    dump("type", result["pred_primitives"], fmt="%d")
    if save_gt:
        dump("GT_inst", batch_i["labels"], fmt="%d")
        dump("GT_type", batch_i["prim"], fmt="%d")
    pts = batch_i["points"]
    dump("Vis_type", visual_labels(pts, result["pred_primitives"]),
         fmt="%0.4f", delimiter=";")
    dump("Vis_inst", visual_labels(pts, result["cluster_ids"]),
         fmt="%0.4f", delimiter=";")
    dump("edge", result["edge_prob"], fmt="%0.4f", delimiter=";")
    dump("GT_points", np.concatenate([pts, batch_i["normals"]], -1),
         fmt="%0.4f", delimiter=";")


def run_postproc(out_dir: str, shape_id, batch_i: dict, result: dict):
    """Fitted primitives, intersection curves, corners and trimmed meshes
    of one shape from its predictions (reference:
    Fitting_patches_and_edges/primitive_forward_v2.py __main__ and
    arg2mesh; `sednet_tpu/predict.py:615`): writes
    paras/param_{id}.txt, paras/param_inter_lines_{id}.json and
    {id}_mesh/ under out_dir. Returns `process_shape`'s result."""
    from sednet_tpu_torch.postproc import process_shape, save_shape_parameters
    from sednet_tpu_torch.postproc.arg2mesh import arg2mesh

    types = project_types_fitting(result["pred_primitives"].astype(np.int64))
    res = process_shape(batch_i["points"].astype(np.float64),
                        batch_i["normals"].astype(np.float64),
                        result["cluster_ids"].astype(np.int64), types)
    save_shape_parameters(out_dir, shape_id, res)
    arg2mesh(os.path.join(out_dir, f"{shape_id}_mesh"),
             os.path.join(out_dir, "paras", f"param_{shape_id}.txt"),
             os.path.join(out_dir, "paras",
                          f"param_inter_lines_{shape_id}.json"))
    return res


def predict_loader(loader, cfg: Config, model_type, model_inst, *,
                   save_viz: bool = True, multi_vote: bool = False,
                   fold5drop: bool = False, out_dir=None, limit=None,
                   postproc: bool = False):
    """The test loop of `run_prediction` over a `BatchLoader` (its
    `starts` offsets the shape ids), double-buffered as
    `sednet_tpu/predict.py:743-762` through `predict_shapes_stream`: batch
    k+1's device half is enqueued before batch k's host half, metric log
    lines, txt dumps (a pool of 4
    threads, drained after each batch so that an IO error surfaces there)
    and, with `postproc`, `run_postproc`. Every batch draws from
    `batch_generator(cfg.seed)`, so each batch's results equal those of
    `predict_shapes` on it with that generator. `limit` stops after that
    many shapes. Returns (summary, per-shape results)."""
    out_dir = out_dir or "predictions/results"
    cache = SpectralCache(os.path.join(out_dir, "normal_smooth_cache"),
                          cfg.spectral_sigma, cfg.spectral_knn)
    tta_fn = make_tta_type_log_prob(model_type, cfg, multi_vote, fold5drop)
    forward_fn = make_forward(model_inst, fused=cfg.fused_encoder)
    starts = loader.starts
    all_metrics = []
    fed = []        # (batch, shape ids) in the order the stream takes them
    dump_pool = (concurrent.futures.ThreadPoolExecutor(max_workers=4)
                 if save_viz else None)
    dump_futs = []

    def drain_dumps(done_only=True):
        rest = []
        for f in dump_futs:
            if not done_only or f.done():
                f.result()
            else:
                rest.append(f)
        dump_futs[:] = rest

    def feed():
        enq = starts
        for batch in loader:
            ids = list(range(enq, enq + batch["points"].shape[0]))
            enq += len(ids)
            fed.append((batch, ids))
            yield batch, ids
            if limit and enq - starts >= limit:
                return

    try:
        stream = predict_shapes_stream(
            model_type, model_inst, feed(), cfg,
            generators=lambda k: batch_generator(cfg.seed), cache=cache,
            tta_fn=tta_fn, forward_fn=forward_fn)
        for k, results in enumerate(stream):
            batch, ids = fed[k]
            fed[k] = None
            if limit:
                results = results[: max(limit - len(all_metrics), 0)]
            for i, r in enumerate(results):
                logger.info("ID:%d | inst_iou: %s type_iou: %s "
                            "inst_recall: %s%s", ids[i], r["inst_iou"],
                            r["type_iou"], r["inst_recall"],
                            " [GUARD-CAPPED]" if r["guard_capped"] else "")
                all_metrics.append(r)
                item = {key: batch[key][i] for key in batch}
                if save_viz:
                    dump_futs.append(dump_pool.submit(
                        save_shape_outputs, out_dir, ids[i], item, r))
                if postproc:
                    run_postproc(out_dir, ids[i], item, r)
            if dump_pool is not None:
                drain_dumps(done_only=True)
        if dump_pool is not None:
            drain_dumps(done_only=False)
    finally:
        if dump_pool is not None:
            dump_pool.shutdown()

    return _summary(all_metrics), all_metrics


def batch_draws(batch: dict, cfg: Config, generator):
    """The random inputs `predict_shapes` draws for a batch, drawn in its
    order from `generator`: each shape's LOBPCG start block (under
    hpnet_embed), then each shape's bandwidth subsample. Returns (x0s or
    None, sels)."""
    b, n = np.asarray(batch["points"]).shape[:2]
    x0s = ([torch.randn((n, cfg.spectral_eigvecs), generator=generator)
            for _ in range(b)] if cfg.hpnet_embed else None)
    m = min(cluster_settings(cfg, cfg.num_points)["num_samples"], n)
    return x0s, [torch.randperm(n, generator=generator)[:m]
                 for _ in range(b)]


def predict_shapes_mesh(model_type, model_inst, batch: dict, cfg: Config,
                        mesh, *, generator=None, multi_vote: bool = False,
                        fold5drop: bool = False, tta_fn=None,
                        forward_fn=None):
    """`predict_shapes` with the batch's shapes sharded over the ranks of
    `mesh` (`sednet_tpu/predict.py`'s mesh branch; B divisible by the
    mesh size): every rank draws the whole batch's random inputs from its
    copy of `generator` (`batch_draws`, the draws of one `predict_shapes`
    call on the whole batch), runs its B/M shapes on them, and the results
    are gathered, in shape order, on every rank. So the results equal
    those of `predict_shapes` on the whole batch with that generator; a
    shape whose guarded clustering retries draws its retry from the
    generator's state after the batch's draws, which one process reaches
    only where no earlier shape of the batch retried."""
    from sednet_tpu_torch.parallel.mesh import (check_divisible,
                                                gather_objects, local_rows)

    b = np.asarray(batch["points"]).shape[0]
    check_divisible(b, mesh.size)
    x0s, sels = batch_draws(batch, cfg, generator)
    sl = local_rows(b, mesh)
    local = {k: np.asarray(v)[sl] for k, v in batch.items()}
    res = predict_shapes(model_type, model_inst, local, cfg,
                         generator=generator, multi_vote=multi_vote,
                         fold5drop=fold5drop, tta_fn=tta_fn,
                         forward_fn=forward_fn,
                         x0s=None if x0s is None else x0s[sl], sels=sels[sl])
    return [r for part in gather_objects(res, mesh) for r in part]


def predict_loader_mesh(loader, cfg: Config, model_type, model_inst, mesh, *,
                        save_viz: bool = True, multi_vote: bool = False,
                        fold5drop: bool = False, out_dir=None, limit=None,
                        postproc: bool = False):
    """`predict_loader` data-parallel over the ranks of `mesh`: every rank
    reads every batch, pads a final partial batch to a multiple of the mesh
    size with copies of its last shape (`sednet_tpu/predict.py:712-713`,
    their results dropped), runs `predict_shapes_mesh` with
    `batch_generator(cfg.seed)`, and rank 0 logs, dumps and post-processes
    as `predict_loader` does. The spectral cache is not used (JAX's mesh
    branch bypasses it too). Returns (summary, per-shape results), the
    same on every rank."""
    out_dir = out_dir or "predictions/results"
    tta_fn = make_tta_type_log_prob(model_type, cfg, multi_vote, fold5drop)
    forward_fn = make_forward(model_inst, fused=cfg.fused_encoder)
    all_metrics = []
    sid = loader.starts
    for batch in loader:
        b = batch["points"].shape[0]
        pad = -b % mesh.size
        if pad:
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in batch.items()}
        results = predict_shapes_mesh(
            model_type, model_inst, batch, cfg, mesh,
            generator=batch_generator(cfg.seed), tta_fn=tta_fn,
            forward_fn=forward_fn)[:b]
        if limit:
            results = results[: max(limit - len(all_metrics), 0)]
        for i, r in enumerate(results):
            all_metrics.append(r)
            if mesh.rank:
                continue
            logger.info("ID:%d | inst_iou: %s type_iou: %s inst_recall: %s%s",
                        sid + i, r["inst_iou"], r["type_iou"],
                        r["inst_recall"],
                        " [GUARD-CAPPED]" if r["guard_capped"] else "")
            item = {key: batch[key][i] for key in batch}
            if save_viz:
                save_shape_outputs(out_dir, sid + i, item, r)
            if postproc:
                run_postproc(out_dir, sid + i, item, r)
        sid += b
        if limit and len(all_metrics) >= limit:
            break
    return _summary(all_metrics), all_metrics


def _summary(all_metrics) -> dict:
    summary = {
        "inst_iou": float(np.mean([m["inst_iou"] for m in all_metrics])),
        "type_iou": float(np.mean([m["type_iou"] for m in all_metrics])),
        "inst_recall": float(np.mean([m["inst_recall"]
                                      for m in all_metrics])),
        "n_shapes": len(all_metrics),
        # shapes where the guarded mean-shift deviated from the
        # reference's unbounded retry (the 16-try cap, the bandwidth's
        # lane cap)
        "guard_capped": int(sum(m["guard_capped"] for m in all_metrics)),
        "guard_bw_capped": int(sum(m["guard_bw_capped"]
                                   for m in all_metrics)),
    }
    logger.info("===========> %s", summary)
    return summary


def _predict_rank(mesh, cfg: Config, kw: dict):
    """One rank of a data-parallel `run_prediction`."""
    return run_prediction(cfg, mesh=mesh, device=mesh.device, **kw)


def run_prediction(cfg: Config, *, data_root=".", save_viz=True,
                   multi_vote=False, fold5drop=False, out_dir=None,
                   batch_size=8, limit=None, params_type=None,
                   params_inst=None, postproc=False, starts=0,
                   mesh_devices=0, device=None, mesh=None):
    """The test loop of the CLI (`sednet_tpu/predict.py:635`). The dataset
    follows cfg.dataset: "my" tests on the SED-Net EdgeDataset set, anything
    else on ParseNet (reference: generate_predictions_aug.py:90-98,176),
    read from h5 files under data_root (h5py). `starts` skips the first
    shapes and offsets the logged ids; `limit` defaults to cfg.num_test.

    params_type / params_inst: loaded port SEDNet models, else read from
    cfg.pretrain_model_path (the TYPE model) and
    cfg.pretrain_model_type_path (the INST model), as the reference maps
    them. device None is the CUDA card. Returns (summary, per-shape
    results) of `predict_loader`.

    mesh_devices = M > 1 shards each batch's shapes over M ranks
    (`predict_loader_mesh`; batch_size divisible by M): in the ranks of
    `mesh` where one is given, else in M processes started here, one a
    card (gloo ranks on the CPU under device="cpu"), each reading the
    models from the config's paths (or from params_type / params_inst's
    state), rank 0's summary and results returned."""
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(device)
    if mesh_devices and mesh_devices > 1:
        from sednet_tpu_torch.parallel.mesh import check_divisible, spawn

        check_divisible(batch_size, mesh_devices)
        if mesh is None:
            states = [None if m is None else
                      {k: v.detach().cpu() for k, v in m.state_dict().items()}
                      for m in (params_type, params_inst)]
            return spawn("sednet_tpu_torch.predict:_predict_rank",
                         mesh_devices, cfg, dict(
                             data_root=data_root, save_viz=save_viz,
                             multi_vote=multi_vote, fold5drop=fold5drop,
                             out_dir=out_dir, batch_size=batch_size,
                             limit=limit, params_type=states[0],
                             params_inst=states[1], postproc=postproc,
                             starts=starts, mesh_devices=mesh_devices),
                         device=dev.type,
                         timeout=float("inf"))
        dev = mesh.device
    if isinstance(params_type, dict) or isinstance(params_inst, dict):
        # a spawned rank's copy of the caller's models, as state dicts
        params_type, params_inst = (
            _model_from_state(p, cfg, dev) if isinstance(p, dict) else p
            for p in (params_type, params_inst))
    if params_type is None:
        params_type = load_checkpoint(cfg.pretrain_model_path, cfg, dev)
    if params_inst is None:
        params_inst = load_checkpoint(cfg.pretrain_model_type_path, cfg, dev)
    for model in (params_type, params_inst):
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"model on {next(model.parameters()).device}, "
                             f"run on {dev}")
    kind = EdgeDataset if cfg.dataset == "my" else ParseNetDataset
    ds = kind(data_root, train=False, normals=cfg.normals,
              num_points=cfg.num_points, max_segments=cfg.ms_max_clusters)
    if limit is None and cfg.num_test:
        limit = cfg.num_test
    loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False,
                         starts=starts)
    if mesh is not None:
        return predict_loader_mesh(loader, cfg, params_type, params_inst,
                                   mesh, save_viz=save_viz,
                                   multi_vote=multi_vote, fold5drop=fold5drop,
                                   out_dir=out_dir, limit=limit,
                                   postproc=postproc)
    return predict_loader(loader, cfg, params_type, params_inst,
                          save_viz=save_viz, multi_vote=multi_vote,
                          fold5drop=fold5drop, out_dir=out_dir, limit=limit,
                          postproc=postproc)


def _model_from_state(state: dict, cfg: Config, device):
    """A SEDNet of cfg carrying `state` (numpy arrays or tensors), on
    device, in eval mode."""
    model = SEDNet.from_config(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.to(device).eval()


def main(argv=None):
    """The CLI, with the reference's positional flags (readme.md:18-22):
    <cfg> [NoSave] [multi_vote] [fold5drop], "postproc" anywhere after the
    config; --starts S skips the first S test shapes, --batch-size B,
    --mesh N (N ranks, one process a card, `run_prediction`'s
    mesh_devices)."""
    argv = sys.argv[1:] if argv is None else argv
    mesh_devices, starts, batch_size = 0, 0, 8
    pos = []
    it = iter(argv)
    for a in it:
        if a == "--mesh":
            mesh_devices = int(next(it))
        elif a == "--starts":
            starts = int(next(it))
        elif a == "--batch-size":
            batch_size = int(next(it))
        else:
            pos.append(a)
    cfg = load_config(pos[0])
    save_viz = not (len(pos) > 1 and pos[1] == "NoSave")
    multi_vote = len(pos) > 2 and pos[2] == "multi_vote"
    fold5drop = len(pos) > 3 and pos[3] == "fold5drop"
    postproc = "postproc" in pos[1:]
    run_prediction(cfg, save_viz=save_viz, multi_vote=multi_vote,
                   fold5drop=fold5drop, postproc=postproc, starts=starts,
                   mesh_devices=mesh_devices, batch_size=batch_size)


if __name__ == "__main__":
    main()
