"""DGCNN encoder (counterpart of `sednet_tpu/models/backbone.py:43-167`).

Channels-last (B, N, C). Three edge convolutions (2*C_in->64, 128->64,
128->128, GroupNorm with 2 groups, LeakyReLU 0.2, max over k neighbours),
each on a kNN graph from kernel K1, then a 256->1024 layer (GroupNorm 8,
ReLU) and a global max. Two edge convolutions, as in JAX: the factored one
(`factored_gn`, the default, float32 only: kernel K6 reduces the gathered
rows) and the direct one (gather, GroupNorm, LeakyReLU, max over K on the
materialised (B, N, K, C) tensor), which every layer takes when
`factored_gn` is off or the compute dtype is bf16 (`config.model_bf16`).

Compute dtype: the parameters stay float32; under bf16 every Dense and
GroupNorm rounds where flax's do (`dense`, `group_norm`), and every kNN
graph is built on float32 values.

Parameter names follow the flax tree, so that `weights.py` maps the
checkpoint's `a/b/c` keys onto `a.b.c` state-dict keys.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sednet_tpu_torch.ops.graph import (edge_conv_factored,
                                        edge_conv_features, locality_order)
from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals


def group_norm(x, groups: int, weight, bias, eps: float = 1e-6):
    """Channels-last GroupNorm as flax computes it (`_compute_stats`,
    `_normalize`): statistics in float32 (or wider) over every axis but
    the batch within each group, variance as E[x^2] - E[x]^2 clamped at 0,
    then (x - mean) * (rsqrt(var + eps) * scale) + bias in float32,
    rounded to x's dtype (bf16 under `model_bf16`) once at the end."""
    shape = x.shape
    g = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
        shape[0], -1, groups, shape[-1] // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    mean2 = (g * g).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * weight.reshape(groups, -1)
    y = (g - mean) * mul + bias.reshape(groups, -1)
    return y.reshape(shape).to(x.dtype)


def dense(lin, x, dtype=torch.float32):
    """flax's Dense at compute dtype `dtype` on the float32 nn.Linear
    `lin`: x and the parameters rounded to dtype, the product rounded to
    dtype, then the bias added in dtype (two roundings, as flax's
    `dot_general` and `y += bias`). float32 is lin(x)."""
    if dtype == torch.float32:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def scaled(w: float, x):
    """w * x as JAX computes a Python float times an array: w rounded to
    x's dtype first."""
    return torch.tensor(w, dtype=x.dtype, device=x.device) * x


def leaky_relu(x, slope: float):
    """flax's leaky_relu, where(x >= 0, x, slope * x), slope in x's
    dtype."""
    return torch.where(x >= 0, x, scaled(slope, x))


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.groups, self.weight, self.bias)


class EdgeConv(nn.Module):
    """kNN graph -> [x_j - x_i, x_i] -> 1x1 conv -> GroupNorm -> LeakyReLU
    -> max over neighbours: through `edge_conv_factored` (kernel K6) when
    `factored_gn` holds and the dtype is float32, as
    `sednet_tpu/models/backbone.py:69` decides, else the direct branch
    (`edge_conv_direct`). Both read the same `conv` and `gn` parameters."""

    def __init__(self, c_in: int, c_out: int, groups: int = 2,
                 negative_slope: float = 0.2, *, dtype=torch.float32,
                 factored_gn: bool = True):
        super().__init__()
        self.conv = nn.Linear(2 * c_in, c_out, bias=False)
        self.gn = GroupNorm(groups, c_out)
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.factored_gn = factored_gn

    def forward(self, x, idx, order=None):
        if self.factored_gn and self.dtype == torch.float32:
            return edge_conv_factored(
                x, idx, self.conv.weight, self.gn.weight, self.gn.bias,
                groups=self.gn.groups, negative_slope=self.negative_slope,
                order=order)
        return edge_conv_direct(x, idx, self.conv.weight, self.gn.weight,
                                self.gn.bias, groups=self.gn.groups,
                                negative_slope=self.negative_slope,
                                dtype=self.dtype)


def edge_conv_direct(x, idx, weight, scale, bias, *, groups: int,
                     negative_slope: float = 0.2, dtype=torch.float32):
    """The direct edge convolution of `sednet_tpu/models/backbone.py:74-78`:
    f = conv([x_j - x_i, x_i]) through `edge_conv_features` in `dtype`,
    GroupNorm over (N, K, C/groups) with float32 statistics, LeakyReLU,
    max over K. x: (B, N, C_in), idx: (B, N, K), weight (C, 2 C_in).
    Returns (B, N, C) in dtype."""
    f = edge_conv_features(x.to(dtype), idx, weight.to(dtype))
    f = group_norm(f, groups, scale, bias)
    return leaky_relu(f, negative_slope).amax(dim=2)


def sorted_graph(idx1, perm, inv):
    """A first-layer graph of original point ids re-expressed in the
    sorted order `perm` (inv its inverse): new[b, i, j] = inv[b, old[b,
    perm[b, i], j]] (`sednet_tpu/models/backbone.py:134-140`)."""
    rows = torch.gather(idx1, 1, perm[..., None].expand(-1, -1,
                                                        idx1.shape[2]))
    return torch.gather(inv, 1, rows.reshape(rows.shape[0], -1)
                        ).reshape(rows.shape)


class DGCNNEncoder(nn.Module):
    """mode 5: x is (B, N, 6) xyz ++ normals, the first graph uses the
    position*(1 + W*normal) metric; mode 0: x is (B, N, 3).

    sort_points: run the whole encoder in the Morton order of the points
    (`sednet_tpu/models/backbone.py:123-166`): one permutation at entry and
    one inverse at exit, so that the three graphs (kernel K1, told the rows
    are already ordered) and the gather-reduces share one order; off by
    default (on the H100 layer 2's graph takes longer on rows in that
    order, PERF.md's K1 rows). Every layer is permutation-equivariant, so
    the result is the same up to float summation order."""

    def __init__(self, mode: int = 5, k: int = 64,
                 normal_metric_w: float = 1.0, *, dtype=torch.float32,
                 factored_gn: bool = True, sort_points: bool = False):
        super().__init__()
        if mode not in (0, 5):
            raise ValueError(f"mode {mode} is not ported (0 or 5)")
        self.mode, self.k, self.normal_metric_w = mode, k, normal_metric_w
        self.dtype, self.sort_points = dtype, sort_points
        c_in = 6 if mode == 5 else 3
        kw = dict(dtype=dtype, factored_gn=factored_gn)
        self.conv1 = EdgeConv(c_in, 64, **kw)
        self.conv2 = EdgeConv(64, 64, **kw)
        self.conv3 = EdgeConv(64, 128, **kw)
        self.mlp1 = nn.Linear(256, 1024)
        self.gn_mlp1 = GroupNorm(8, 1024)

    def _graph_builder(self, perm, inv):
        """build(x, first=False) -> the kNN graph of x's rows (the first
        layer's metric where first). perm / inv: None, or the Morton order
        x's rows stand in and its inverse: K1 then runs with spatial_sort
        off and perm as its column ids, so that ties go to the lower
        original index as without the order, and the ids it lists map back
        to sorted positions through inv. Unsorted (None), K1 takes the rows
        as they come: the encoder's graphs follow `sort_points` alone."""
        kw = dict(spatial_sort=False,
                  col_ids=None if perm is None else perm)

        def build(x, first=False):
            if first and self.mode == 5:
                idx = knn_indices_points_normals(
                    x, self.k, normal_metric_w=self.normal_metric_w, **kw)
            else:
                idx = knn_indices(x, self.k, **kw)
            if inv is None:
                return idx
            return torch.gather(inv, 1, idx.reshape(idx.shape[0], -1)
                                ).reshape(idx.shape)

        return build

    def forward(self, x, idx1=None, graphs=None):
        """Returns (global (B, 1024), per-point features (B, N, 256)), in
        the compute dtype. idx1: a precomputed first-layer graph. graphs:
        all three layers' graphs (idx1, idx2, idx3), each (B, N, k) of
        original point ids, taken instead of building any (a caller that
        holds another implementation's graphs, as the parity tests do).
        One Morton order of the points (`locality_order`) is the row order
        of the three gather-reduces (kernel K6), changing no value."""
        use_sort = self.sort_points and graphs is None
        order = locality_order(x[..., :3])
        build = self._graph_builder(None, None)
        if use_sort:
            perm = order.long()
            inv = torch.argsort(perm, dim=1)
            x = torch.gather(x, 1, perm[..., None].expand(-1, -1,
                                                          x.shape[-1]))
            if idx1 is not None:
                idx1 = sorted_graph(idx1, perm, inv)
            # the rows are in Morton order now: the gathers walk them as
            # they are, and K1 takes them as they are, keyed by the points'
            # original indices
            order, build = None, self._graph_builder(order, inv)
        if graphs is not None:
            idx1, idx2, idx3 = graphs
        elif idx1 is None:
            idx1 = build(x, first=True)
        x1 = self.conv1(x, idx1, order)
        if graphs is None:
            idx2 = build(x1.float())
        x2 = self.conv2(x1, idx2, order)
        if graphs is None:
            idx3 = build(x2.float())
        x3 = self.conv3(x2, idx3, order)
        feats = torch.cat([x1, x2, x3], dim=-1)
        h = F.relu(self.gn_mlp1(dense(self.mlp1, feats, self.dtype)))
        if use_sort:
            feats = torch.gather(feats, 1, inv[..., None].expand(
                -1, -1, feats.shape[-1]))
        return h.amax(dim=1), feats
