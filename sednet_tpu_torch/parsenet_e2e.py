"""End-to-end ParseNet training: embedding + type + differentiable fitting
residual loss.

Counterpart of `sednet_tpu/parsenet_e2e.py` (reference:
Fitting_patches_and_edges/splinenet/train_parsenet_e2e.py,
PrimitivesEmbeddingDGCNGne2e, Evaluation.fitting_loss in
residual_utils.py:86-209). A step is cut where JAX cuts it:

  A (device, no gradient): forward, then per shape `cluster_for_matching`:
     the bandwidth (quantile 0.125), 5 mean-shift steps (kernel K2) and NMS
     (kernel K3) -> cluster ids;
  B (host): Hungarian match of clusters to true segments
     (`fit.evaluation.match`), the majority true type per matched cluster
     -> fixed-shape (K, N) masks and (K,) fit codes (`build_match_arrays`);
  C (device, gradient): embedding -> centers -> mean-shift-kernel
     memberships (`weights_normalize`) -> weighted fits of the matched
     segments -> residuals against the matched true masks, with the > 1 ->
     0.1 clamp (`e2e_fitting_loss`), plus the triplet and smoothed type
     losses; the encoder's backward runs kernel K6b. Spline segments have
     no residual.

What differs from JAX, by design:
  * JAX vmaps a `lax.switch` over the K = 50 segments, which evaluates all
    four fits for every segment and selects one; the port fits each
    primitive only on the segments of its type (one batched call a type)
    and leaves the unmatched segments out. The values are the same; where
    a fit that JAX evaluates and discards has a non-finite gradient, JAX's
    gradient is NaN (0 times inf) and the port's is not;
  * random draws (the bandwidth subsample, the triplet samples and pairs)
    come from a `torch.Generator`; tests inject JAX's (`sel`, `draws`).
"""
from __future__ import annotations

import numpy as np
import torch

from sednet_tpu_torch.cluster.mean_shift import (compute_bandwidth,
                                                 mean_shift_iterate, nms)
from sednet_tpu_torch.fit.evaluation import match, weights_normalize
from sednet_tpu_torch.fit.primitives import (fit_cone, fit_cylinder,
                                             fit_plane, fit_sphere)
from sednet_tpu_torch.fit.residuals import (distance_from_cone,
                                            distance_from_cylinder,
                                            distance_from_plane,
                                            distance_from_sphere)
from sednet_tpu_torch.losses import (TripletConfig, label_smoothing_nll,
                                     triplet_loss)
from sednet_tpu_torch.losses.embedding import sample_draws
from sednet_tpu_torch.ops.cuda_kernels import kernel_width
from sednet_tpu_torch.train import (TrainState, clip_by_global_norm,
                                    model_input, remap_train_types)
from sednet_tpu_torch.utils.tracing import trace

MAX_SEGS = 50
# fitting-type codes
F_NONE, F_PLANE, F_SPHERE, F_CYLINDER, F_CONE = 0, 1, 2, 3, 4
_TYPE_TO_F = {1: F_PLANE, 5: F_SPHERE, 4: F_CYLINDER, 3: F_CONE}
_MIN_BANDWIDTH = 0.003

# the trace ranges of e2e_train_batch, in the order they run
STAGES = tuple(f"parsenet_e2e/{s}" for s in ("cluster", "match", "step"))


@torch.no_grad()
def cluster_for_matching(embedding, *, num_samples: int = 10000,
                         quantile=0.125, iterations: int = 5, generator=None,
                         sel=None):
    """Phase A for one shape's embedding (N, E): rows L2-normalised, the
    bandwidth over a subsample of min(num_samples, N) rows (`sel`, or drawn
    from `generator`) clamped to at least 0.003, `iterations` mean-shift
    steps without an early exit (K2), then NMS (K3). Returns (cluster_ids
    (N,) int64, center_mask (N,) bool, bandwidth 0-d float32).

    At 10000 samples and quantile 0.125 the bandwidth's k (1250) clips to
    256, above K1's 128: the k-th distances come from the dense (m, m)
    path, as in JAX (`cluster/mean_shift.py:80-82`)."""
    emb = embedding / torch.clamp_min(
        torch.linalg.vector_norm(embedding, dim=-1, keepdim=True), 1e-12)
    emb = kernel_width(emb)
    bw = torch.clamp_min(compute_bandwidth(
        emb, min(num_samples, emb.shape[0]), np.float32(quantile),
        generator=generator, sel=sel), _MIN_BANDWIDTH)
    shifted = mean_shift_iterate(emb, bw, iterations)
    labels, center_mask, _ = nms(shifted, emb, float(bw))
    return labels, center_mask, bw


def build_match_arrays(cluster_ids: np.ndarray, center_mask: np.ndarray,
                       gt_labels: np.ndarray, gt_types: np.ndarray, *,
                       device=None):
    """Phase B (host): per-cluster matched true masks and fit codes; the
    relaxed IoU of the match runs on `device` (None: the card).

    Returns (center_rows (K,), seg_fit_type (K,), gt_mask (K, N), pred_mask
    (K, N)) as numpy, K = MAX_SEGS."""
    n = cluster_ids.shape[0]
    rows, cols, _, _ = match(gt_labels, cluster_ids, device=device)
    col_of = dict(zip(rows.tolist(), cols.tolist()))
    center_rows = np.zeros(MAX_SEGS, np.int32)
    nz = np.nonzero(center_mask)[0]
    center_rows[: min(len(nz), MAX_SEGS)] = nz[:MAX_SEGS]
    seg_type = np.zeros(MAX_SEGS, np.int32)
    gt_mask = np.zeros((MAX_SEGS, n), np.float32)
    pred_mask = np.zeros((MAX_SEGS, n), np.float32)
    for i in np.unique(cluster_ids):
        if i >= MAX_SEGS:
            continue
        c = col_of.get(int(i))
        if c is None:
            continue
        g = gt_labels == c
        p = cluster_ids == i
        if g.sum() < 100 or p.sum() < 20:
            continue
        vals, counts = np.unique(gt_types[g], return_counts=True)
        t = int(vals[np.argmax(counts)])
        seg_type[i] = _TYPE_TO_F.get(t, F_NONE)
        gt_mask[i] = g
        pred_mask[i] = p
    return center_rows, seg_type, gt_mask, pred_mask


def _fit_distances(code, points, normals, w, gt_w):
    """The residual of each segment of one fit type: w, gt_w (S, N) the
    fit's weights and the true masks. Returns (S,)."""
    s, n = w.shape
    pts = points.expand(s, n, 3)
    if code == F_PLANE:
        params = fit_plane(pts, w)
        dist = distance_from_plane
    elif code == F_SPHERE:
        params = fit_sphere(pts, w)
        dist = distance_from_sphere
    elif code == F_CYLINDER:
        params = fit_cylinder(pts, normals.expand(s, n, 3), w)
        dist = distance_from_cylinder
    else:
        params = fit_cone(pts, normals.expand(s, n, 3), w)
        dist = distance_from_cone
    return torch.stack([dist(points, *(p[j] for p in params),
                             weights=gt_w[j]) for j in range(s)])


def e2e_fitting_loss(embedding, points, normals, center_rows, seg_type,
                     gt_mask, bandwidth):
    """Phase C: the differentiable residual loss of one shape.

    embedding (N, E); points, normals (N, 3); center_rows, seg_type (K,);
    gt_mask (K, N); bandwidth a float32 scalar. Every fit code > 0 fits its
    segments with the memberships (plus 1e-8) of the K centers; each
    residual above 1 counts 0.1; the loss is the mean over those segments
    (0 without any). seg_type is read on the host."""
    emb = embedding / torch.clamp_min(
        torch.linalg.vector_norm(embedding, dim=-1, keepdim=True), 1e-12)
    centers = emb[torch.as_tensor(center_rows, device=emb.device).long()]
    sims = centers @ emb.T                                       # (K, N)
    bw = torch.as_tensor(bandwidth, dtype=emb.dtype, device=emb.device)
    w = weights_normalize(sims, bw)                              # (K, N)
    gt_mask = torch.as_tensor(gt_mask, dtype=emb.dtype, device=emb.device)
    codes = np.asarray(torch.as_tensor(seg_type).cpu())
    res = []
    for code in (F_PLANE, F_SPHERE, F_CYLINDER, F_CONE):
        rows = torch.from_numpy(np.nonzero(codes == code)[0]).to(emb.device)
        if rows.numel():
            res.append(_fit_distances(code, points, normals, w[rows] + 1e-8,
                                      gt_mask[rows]))
    if not res:
        return emb.sum() * 0.0
    d = torch.cat(res)
    # degenerate clamp (reference: eval_utils.py:149-152)
    d = torch.where(d > 1.0, torch.full_like(d, 0.1), d)
    return d.sum() / max(d.numel(), 1)


def make_e2e_loss_fn(model, cfg, fitting_weight: float = 1.0):
    """loss_fn(batch, match_arrays, bandwidths, draws=None, generator=None)
    -> (total, metrics): the triplet loss (cfg.triplet_margin, MAX_SEGS
    segments), the label-smoothed type NLL and fitting_weight times the
    batch mean of `e2e_fitting_loss`, differentiable in the model's
    parameters (`sednet_tpu/parsenet_e2e.py:153-188`). match_arrays:
    (center_rows (B, K), seg_type (B, K), gt_mask (B, K, N)); bandwidths
    (B,) float32; draws / generator: the triplet loss's (`losses.
    triplet_loss`, JAX-shaped draws accepted)."""
    tri_cfg = TripletConfig(max_segments=MAX_SEGS, margin=cfg.triplet_margin)

    def loss_fn(batch, match_arrays, bandwidths, draws=None, generator=None):
        out = model(model_input(batch, cfg.normals))
        prim = remap_train_types(batch["prim"])
        emb_loss = triplet_loss(out.embedding, batch["labels"], tri_cfg,
                                draws=draws, generator=generator)
        p_loss = label_smoothing_nll(out.type_log_prob, prim, cfg.smooth)
        center_rows, seg_type, gt_mask = match_arrays
        fit_loss = torch.stack([e2e_fitting_loss(
            out.embedding[i], batch["points"][i], batch["normals"][i],
            center_rows[i], seg_type[i], gt_mask[i], bandwidths[i])
            for i in range(out.embedding.shape[0])]).mean()
        total = emb_loss + p_loss + fitting_weight * fit_loss
        return total, {"loss": total.detach(), "emb": emb_loss.detach(),
                       "type": p_loss.detach(), "fit": fit_loss.detach()}

    return loss_fn


def make_e2e_train_step(model, optimizer, cfg, fitting_weight: float = 1.0):
    """step(batch, match_arrays, bandwidths, draws=None, generator=None) ->
    metrics: one gradient step of `make_e2e_loss_fn`'s loss (backward, the
    global-norm clip where cfg.grad_clip > 0, as `train.make_train_step`
    runs it, the optimizer's update). The caller supplies the phase-B
    arrays per batch item."""
    loss_fn = make_e2e_loss_fn(model, cfg, fitting_weight)
    params = list(model.parameters())

    def step(batch, match_arrays, bandwidths, draws=None, generator=None):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, match_arrays, bandwidths, draws,
                                 generator)
        total.backward()
        if cfg.grad_clip > 0:
            clip_by_global_norm(params, cfg.grad_clip)
        optimizer.step()
        return metrics

    return step


def e2e_train_batch(model, state: TrainState, batch, cfg, step_fn,
                    generator: torch.Generator, timings=None):
    """One A -> B -> C iteration over a batch dict of tensors on the
    model's device ("points", "normals", "labels", "prim"), with two
    forwards as in JAX: phase A's without a gradient, then the step's.
    generator draws each shape's bandwidth subsample, then the triplet
    draws, which step_fn gets as `draws`. timings: optional dict that
    `utils.tracing.trace` fills with each phase's host seconds (`STAGES`;
    the step's enqueues its work without waiting for it). Returns
    (TrainState with step + 1, metrics)."""
    b, n = batch["points"].shape[:2]
    dev = batch["points"].device
    with trace(STAGES[0], timings):
        with torch.no_grad():
            out = model(model_input(batch, cfg.normals))
        found = [cluster_for_matching(out.embedding[i],
                                      num_samples=min(10000, n),
                                      generator=generator) for i in range(b)]
        found = [(cid.cpu().numpy(), cmask.cpu().numpy(), bw)
                 for cid, cmask, bw in found]
    with trace(STAGES[1], timings):
        labels = batch["labels"].cpu().numpy()
        prim = batch["prim"].cpu().numpy()
        rows, types, masks = [], [], []
        for i, (cid, cmask, _) in enumerate(found):
            cr, st, gm, _ = build_match_arrays(cid, cmask, labels[i],
                                               prim[i], device=dev)
            rows.append(cr)
            types.append(st)
            masks.append(gm)
        match_arrays = tuple(torch.from_numpy(np.stack(a)).to(dev)
                             for a in (rows, types, masks))
        bandwidths = torch.stack([bw for _, _, bw in found])
    with trace(STAGES[2], timings):
        draws = sample_draws(batch["labels"], TripletConfig(
            max_segments=MAX_SEGS, margin=cfg.triplet_margin), generator)
        metrics = step_fn(batch, match_arrays, bandwidths, draws)
    return TrainState(state.model, state.optimizer, state.step + 1), metrics
