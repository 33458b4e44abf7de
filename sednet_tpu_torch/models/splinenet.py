"""SplineNet: a control-point grid for an open or closed B-spline patch.

Counterpart of `sednet_tpu/models/splinenet.py:23-69` (reference:
src/model.py:56-180, DGCNNControlPoints mode 0): four edge convolutions
(BatchNorm, LeakyReLU 0.2, max over the k = 10 neighbours), each on a kNN
graph from kernel K1; a 512 -> 1024 layer (BatchNorm, LeakyReLU) and a
global max of the features times each point's membership weight; two
1024 layers (BatchNorm, ReLU); 3 grid^2 outputs through tanh.

BatchNorm is flax's (`BatchNorm`): statistics over every axis but the
last, the variance as E[x^2] - E[x]^2 clamped at 0 (biased), epsilon 1e-5,
the running statistics when train=False. The edge convolution factors the
1x1 conv through the gather as `sednet_tpu/ops/graph.py:52
edge_conv_features` does, and gathers the (B, N, K, C) pre-activation with
the plain `gather_neighbors`, as JAX gathers with XLA: BatchNorm in
training needs its statistics over all of it. Parameter and buffer names
follow the flax tree (`weights.splinenet_from_variables`).
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sednet_tpu_torch.ops.graph import gather_neighbors
from sednet_tpu_torch.ops.knn import knn_indices


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the last axis (defaults: momentum 0.99,
    epsilon 1e-5, scale and bias). `mean` and `var` are flax's
    batch_stats."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class BNEdgeConv(nn.Module):
    """kNN graph (K1) -> conv([x_j - x_i, x_i]) -> BatchNorm -> LeakyReLU
    0.2 -> max over the k neighbours."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.k = k
        self.conv = nn.Linear(2 * c_in, c_out, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, x, train: bool = False):
        idx = knn_indices(x, self.k)
        w = self.conv.weight
        a = F.linear(x, w[:, : x.shape[-1]])          # x W_top^T
        b = F.linear(torch.cat([-x, x], -1), w)       # x (W_bot - W_top)^T
        f = gather_neighbors(a, idx) + b[:, :, None, :]
        return F.leaky_relu(self.bn(f, train), 0.2).amax(2)


class SplineNet(nn.Module):
    """Predicts a (grid x grid) control-point grid from a point patch."""

    def __init__(self, grid_size: int = 20, k: int = 10):
        super().__init__()
        self.grid_size, self.k = grid_size, k
        self.conv1 = BNEdgeConv(3, 64, k)
        self.conv2 = BNEdgeConv(64, 64, k)
        self.conv3 = BNEdgeConv(64, 128, k)
        self.conv4 = BNEdgeConv(128, 256, k)
        self.conv5 = nn.Linear(512, 1024, bias=False)
        self.bn5 = BatchNorm(1024)
        self.conv6 = nn.Linear(1024, 1024)
        self.bn6 = BatchNorm(1024)
        self.conv7 = nn.Linear(1024, 1024)
        self.bn7 = BatchNorm(1024)
        self.conv8 = nn.Linear(1024, 3 * grid_size ** 2)

    def forward(self, x, weights=None, train: bool = False):
        """x (B, N, 3) float32, weights optional (B, N) membership.
        Returns (B, grid^2, 3) control points in [-1, 1]."""
        x1 = self.conv1(x, train)
        x2 = self.conv2(x1, train)
        x3 = self.conv3(x2, train)
        x4 = self.conv4(x3, train)
        h = self.bn5(self.conv5(torch.cat([x1, x2, x3, x4], -1)), train)
        h = F.leaky_relu(h, 0.2)
        if weights is not None:
            h = h * weights[..., None]
        g = h.amax(1)
        g = F.relu(self.bn6(self.conv6(g), train))
        g = F.relu(self.bn7(self.conv7(g), train))
        g = torch.tanh(self.conv8(g))
        return g.reshape(x.shape[0], self.grid_size ** 2, 3)
