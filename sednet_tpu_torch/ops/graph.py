"""Edge convolution of the DGCNN encoder, factored through the gather.

Counterpart of `sednet_tpu/ops/graph.py:17-39,74-141`, in plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_neighbors(x, idx):
    """x: (B, N, C), idx: (B, N, K) -> (B, N, K, C), one flat gather.
    Indices are clamped into [0, N) first, so that an out-of-range index
    reads its own shape's last row and never another shape's."""
    b, n, c = x.shape
    idx = idx.clamp(0, n - 1)
    off = (torch.arange(b, device=x.device, dtype=idx.dtype) * n)[:, None, None]
    flat = x.reshape(b * n, c)[(idx + off).reshape(-1)]
    return flat.reshape(*idx.shape, c)


def edge_conv_factored(x, idx, weight, scale, bias, *, groups: int,
                       negative_slope: float = 0.2, eps: float = 1e-6):
    """leaky_relu(GroupNorm(conv([x_j - x_i, x_i]))).max over neighbours,
    without the (B, N, K, C) pre-activation tensor's GroupNorm pass.

    weight: (C, 2*C_in), the bias-free 1x1 conv. With W_top = weight[:, :C_in]
    and W_bot = weight[:, C_in:], conv([x_j - x_i, x_i]) = a[j] + bb[i] with
    a = x W_top^T and bb = x (W_bot - W_top)^T. One gather of a (signed by
    the GroupNorm scale) gives the sum, the sum of squares and the signed
    extremum over K; the GroupNorm statistics follow from them with the
    fixed count N*K*gsz, as flax computes them (mean of squares minus
    squared mean, eps 1e-6 inside the rsqrt). GroupNorm affine plus
    LeakyReLU is monotone per channel in the direction of sign(scale), so
    the max over K is taken before them.

    x: (B, N, C_in), idx: (B, N, K); scale, bias: (C,). Returns (B, N, C).
    """
    c_in = x.shape[-1]
    w_top = weight[:, :c_in]
    a = F.linear(x, w_top)
    bb = F.linear(x, weight[:, c_in:] - w_top)
    sign = torch.where(scale >= 0, 1.0, -1.0)

    g = gather_neighbors(a * sign, idx)               # (B, N, K, C)
    s = g.sum(2) * sign
    sq = (g * g).sum(2)
    ext = g.amax(2) * sign
    del g

    b, n, c = a.shape
    k = idx.shape[2]
    gsz = c // groups

    def grp(v):
        return v.reshape(b, n, groups, gsz)

    tot = float(n * k * gsz)
    s1 = grp(s + k * bb).sum(dim=(1, 3))
    s2 = grp(sq + 2.0 * bb * s + k * bb * bb).sum(dim=(1, 3))
    mean = s1 / tot
    var = torch.clamp_min(s2 / tot - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps)

    mean_c = mean.repeat_interleave(gsz, dim=1)[:, None, :]
    mul_c = mul.repeat_interleave(gsz, dim=1)[:, None, :]
    y = (ext + bb - mean_c) * mul_c * scale + bias
    return F.leaky_relu(y, negative_slope)
