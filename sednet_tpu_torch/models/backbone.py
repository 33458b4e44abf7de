"""DGCNN encoder (counterpart of `sednet_tpu/models/backbone.py:43-167`).

Channels-last (B, N, C). Three edge convolutions (2*C_in->64, 128->64,
128->128, GroupNorm with 2 groups, LeakyReLU 0.2, max over k neighbours),
each on a kNN graph from kernel K1, then a 256->1024 layer (GroupNorm 8,
ReLU) and a global max. Only the factored-GroupNorm edge convolution is
ported: it is the JAX package's default (`config.py:124`).

Parameter names follow the flax tree, so that `weights.py` maps the
checkpoint's `a/b/c` keys onto `a.b.c` state-dict keys.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sednet_tpu_torch.ops.graph import edge_conv_factored
from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals


def group_norm(x, groups: int, weight, bias, eps: float = 1e-6):
    """Channels-last GroupNorm as flax computes it: statistics over every
    axis but the batch within each group, variance as E[x^2] - E[x]^2
    clamped at 0, eps 1e-6 inside the rsqrt."""
    shape = x.shape
    g = x.reshape(shape[0], -1, groups, shape[-1] // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    mean2 = (g * g).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    y = (g - mean) * torch.rsqrt(var + eps)
    return y.reshape(shape) * weight + bias


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
    -> max over neighbours, through `edge_conv_factored`."""

    def __init__(self, c_in: int, c_out: int, groups: int = 2,
                 negative_slope: float = 0.2):
        super().__init__()
        self.conv = nn.Linear(2 * c_in, c_out, bias=False)
        self.gn = GroupNorm(groups, c_out)
        self.negative_slope = negative_slope

    def forward(self, x, idx):
        return edge_conv_factored(
            x, idx, self.conv.weight, self.gn.weight, self.gn.bias,
            groups=self.gn.groups, negative_slope=self.negative_slope)


class DGCNNEncoder(nn.Module):
    """mode 5: x is (B, N, 6) xyz ++ normals, the first graph uses the
    position*(1 + W*normal) metric; mode 0: x is (B, N, 3)."""

    def __init__(self, mode: int = 5, k: int = 64,
                 normal_metric_w: float = 1.0):
        super().__init__()
        if mode not in (0, 5):
            raise ValueError(f"mode {mode} is not ported (0 or 5)")
        self.mode, self.k, self.normal_metric_w = mode, k, normal_metric_w
        c_in = 6 if mode == 5 else 3
        self.conv1 = EdgeConv(c_in, 64)
        self.conv2 = EdgeConv(64, 64)
        self.conv3 = EdgeConv(64, 128)
        self.mlp1 = nn.Linear(256, 1024)
        self.gn_mlp1 = GroupNorm(8, 1024)

    def forward(self, x, idx1=None):
        """Returns (global (B, 1024), per-point features (B, N, 256))."""
        if idx1 is None:
            idx1 = (knn_indices_points_normals(
                x, self.k, normal_metric_w=self.normal_metric_w)
                if self.mode == 5 else knn_indices(x, self.k))
        x1 = self.conv1(x, idx1)
        x2 = self.conv2(x1, knn_indices(x1, self.k))
        x3 = self.conv3(x2, knn_indices(x2, self.k))
        feats = torch.cat([x1, x2, x3], dim=-1)
        h = F.relu(self.gn_mlp1(self.mlp1(feats)))
        return h.amax(dim=1), feats
