"""SEDNet's forward and clustering on one cloud sharded over the ranks.

Counterpart of `sednet_tpu/parallel/big_forward.py`. The cloud's points are
split into equal row shards over a `Mesh`; every rank holds the model and
its own rows, and no rank ever holds an N x N block:

  * the three kNN graphs are `ring_knn` (kernel K1 on shard pairs);
  * an edge convolution gathers conv(x)'s rows from their all-gather
    (the direct branch: gather, GroupNorm, LeakyReLU, max over K);
  * every GroupNorm takes its statistics from float32 sums all-reduced
    over the ranks, the global max pool from an all-reduced max;
  * the heads are the model's own (`SEDNet.heads`) on the rank's rows,
    with those GroupNorms;
  * `big_cloud_segment` then normalises (or enriches, `hpnet`) the
    embedding, takes the bandwidth on a subsample of the gathered rows,
    runs `mean_shift_iterate_sharded` (kernel K2) and NMS (kernel K3) on
    the gathered shifted rows.

The model is the port's `SEDNet` with the flagship heads (edge module,
late fusion, early fusion), float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sednet_tpu_torch.parallel.intra_shape import (mean_shift_iterate_sharded,
                                                   ring_knn)
from sednet_tpu_torch.parallel.mesh import (Mesh, all_gather_rows,
                                            all_reduce_max, all_reduce_sum,
                                            local_rows)


class BigForwardOutput(NamedTuple):
    embedding: torch.Tensor       # (N/M, emb), this rank's rows
    type_log_prob: torch.Tensor   # (N/M, P)
    edge_logits: torch.Tensor     # (N/M, 2)


def _group_norm(gn, x, mesh: Mesh, eps: float = 1e-6):
    """flax's GroupNorm over the whole cloud: x (..., C) this rank's part;
    per group the float32 sum and sum of squares all-reduced, then the
    mean of squares minus the squared mean."""
    groups, c = gn.groups, x.shape[-1]
    g = x.reshape(-1, groups, c // groups)
    sums = all_reduce_sum(torch.stack([g.sum((0, 2)), (g * g).sum((0, 2))]),
                          mesh)
    count = float(g.shape[0] * g.shape[2] * mesh.size)
    mean = sums[0] / count
    var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps)[:, None] * gn.weight.reshape(groups, -1)
    y = (g - mean[:, None]) * mul + gn.bias.reshape(groups, -1)
    return y.reshape(x.shape)


def _edge_conv(conv, x, idx, mesh: Mesh):
    """The direct edge convolution on this rank's rows x (S, C) with the
    (S, K) global neighbour indices: conv([x_j - x_i, x_i]) factored as
    a[j] + b[i] (a = x W_top, b = x (W_bot - W_top)), a's rows gathered
    from their all-gather."""
    w = conv.conv.weight
    c = x.shape[-1]
    w_top = w[:, :c]
    a = all_gather_rows(F.linear(x, w_top), mesh)
    f = a[idx] + F.linear(x, w[:, c:] - w_top)[:, None, :]
    f = _group_norm(conv.gn, f, mesh)
    return F.leaky_relu(f, conv.negative_slope).amax(dim=1)


@torch.no_grad()
def big_sednet_forward(model, x, mesh: Mesh) -> BigForwardOutput:
    """SEDNet's forward on ONE cloud x (N, C) (every rank passes the whole
    cloud), N sharded over `mesh`:
    returns this rank's rows of the embedding, the type log-probabilities
    and the edge logits. The model's mode, k and metric weight are its
    encoder's."""
    enc = model.encoder
    if not (model.edge_module and model.late_fusion
            and model.combine_label_prim):
        raise ValueError("big_sednet_forward needs the edge module and both "
                         "fusions (the flagship configuration)")
    if model.dtype != torch.float32:
        raise ValueError("big_sednet_forward runs float32 (model_bf16 off)")
    dev = next(model.parameters()).device
    xl = x[local_rows(x.shape[0], mesh)].to(dev).contiguous()
    metric = "points_normals" if enc.mode == 5 else "sqdist"
    idx1, _ = ring_knn(xl, enc.k, mesh, metric=metric,
                       normal_metric_w=enc.normal_metric_w)
    x1 = _edge_conv(enc.conv1, xl, idx1, mesh)
    x2 = _edge_conv(enc.conv2, x1, ring_knn(x1, enc.k, mesh)[0], mesh)
    x3 = _edge_conv(enc.conv3, x2, ring_knn(x2, enc.k, mesh)[0], mesh)
    feats = torch.cat([x1, x2, x3], dim=-1)
    h = F.relu(_group_norm(enc.gn_mlp1, enc.mlp1(feats), mesh))
    global_feat = all_reduce_max(h.amax(dim=0), mesh)
    # the model's own heads, each GroupNorm's statistics over the cloud
    out = model.heads(global_feat[None], feats[None],
                      norm=lambda gn, v: _group_norm(gn, v, mesh))
    return BigForwardOutput(out.embedding[0], out.type_log_prob[0],
                            out.edge_logits[0])


@torch.no_grad()
def big_cloud_segment(model, x, mesh: Mesh, generator=None, *,
                      quantile: float = 0.015, iterations: int = 50,
                      bandwidth_samples: int = 5000, hpnet: bool = False,
                      normal_smooth_w: float = 0.5,
                      spectral_sigma: float = 0.1, spectral_knn: int = 50,
                      spectral_eigvecs: int = 12, x0=None, sel=None):
    """Instance segmentation of one big cloud x (N, C): the sharded
    forward, hpnet's spectral enrichment where asked (mode 5; computed
    whole on every rank from the gathered embedding and the same
    generator, K5 in the "pallas" layout, then sharded again), the
    bandwidth on a subsample of min(bandwidth_samples, N) gathered rows
    (clipped at 0.003), the sharded shift and NMS on the gathered shifted
    rows. generator: the subsample's (and the enrichment's start block's)
    draws, the same on every rank; x0 (N, spectral_eigvecs) and sel, where
    given, are that start block and subsample (as `predict_shapes` takes
    them). Returns (labels (N,) int64,
    num_clusters, type_pred (N,), edge_logits (N, 2)), whole on every
    rank."""
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth, nms
    from sednet_tpu_torch.cluster.spectral import hpnet_enrich

    out = big_sednet_forward(model, x, mesh)
    n = x.shape[0]
    sl = local_rows(n, mesh)
    if hpnet:
        if x.shape[-1] < 6:
            raise ValueError("hpnet enrichment needs normals (mode 5 input)")
        xd = x.to(out.embedding.device)
        if x0 is None:
            x0 = torch.randn((n, spectral_eigvecs), generator=generator)
        emb = hpnet_enrich(all_gather_rows(out.embedding, mesh), xd[:, :3],
                           xd[:, 3:6], x0=x0, normal_smooth_w=normal_smooth_w,
                           sigma=spectral_sigma, knn=spectral_knn,
                           eig_k=spectral_eigvecs,
                           transpose_mode="pallas")[sl].contiguous()
    else:
        emb = out.embedding / torch.clamp_min(torch.linalg.vector_norm(
            out.embedding, dim=-1, keepdim=True), 1e-12)
    emb_all = all_gather_rows(emb, mesh)
    bw = max(float(compute_bandwidth(emb_all, min(bandwidth_samples, n),
                                     quantile, generator=generator,
                                     sel=sel)), 0.003)
    shifted = all_gather_rows(mean_shift_iterate_sharded(
        emb, bw, mesh, iterations=iterations), mesh)
    labels, _, num = nms(shifted, emb_all, bw)
    return (labels, num,
            all_gather_rows(out.type_log_prob.argmax(-1), mesh),
            all_gather_rows(out.edge_logits, mesh))
