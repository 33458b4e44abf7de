"""Edge convolution of the DGCNN encoder, factored through the gather.

Counterpart of `sednet_tpu/ops/graph.py:17-39,74-141`. The gather and its
three reductions over the neighbours are kernel K6 (`gather_reduce`,
`csrc/gather_reduce.cu`, the counterpart of the TPU probe kernel
`scripts/probe_gather_pallas.py:_call`): a CUDA tensor launches it, a CPU
tensor takes `gather_reduce_plain`. Forward only: the kernel has no
backward yet, and a backward through it raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sednet_tpu_torch.ops import _build


def gather_neighbors(x, idx):
    """x: (B, N, C), idx: (B, N, K) -> (B, N, K, C), one flat gather.
    Indices are clamped into [0, N) first, so that an out-of-range index
    reads its own shape's last row and never another shape's."""
    b, n, c = x.shape
    idx = idx.clamp(0, n - 1)
    off = (torch.arange(b, device=x.device, dtype=idx.dtype) * n)[:, None, None]
    flat = x.reshape(b * n, c)[(idx + off).reshape(-1)]
    return flat.reshape(*idx.shape, c)


def gather_reduce_plain(a, idx):
    """Plain PyTorch version of K6: a (B, N, C), idx (B, N, K) ->
    (sum, sum of squares, max) over the K gathered rows, each (B, N, C),
    through the materialised (B, N, K, C) gather (indices clamped into
    [0, N) as in `gather_neighbors`)."""
    g = gather_neighbors(a, idx)
    return g.sum(2), (g * g).sum(2), g.amax(2)


def _gather_reduce_launch(a, idx):
    _build.require_cuda_f32("gather_reduce a", a)
    if a.dim() != 3 or idx.dim() != 3 or idx.shape[:2] != a.shape[:2]:
        raise ValueError("gather_reduce: a (B, N, C) and idx (B, N, K)")
    if idx.device != a.device or idx.dtype != torch.int64:
        raise ValueError("gather_reduce: idx must be int64 on a's device")
    b, n, c = a.shape
    k = idx.shape[2]
    if not 1 <= k <= 128:
        raise ValueError(f"gather_reduce: K={k} outside [1, 128]")
    ap = _build.pad_width(a)
    if ap.data_ptr() % 16:
        raise ValueError("gather_reduce: a must be 16-byte aligned")
    cp = ap.shape[-1]
    idx = idx.contiguous()
    s, sq, mx = (torch.empty((b, n, cp), dtype=torch.float32, device=a.device)
                 for _ in range(3))
    err = _build.lib().sednet_gather_reduce(
        ap.data_ptr(), idx.data_ptr(), b, n, cp, k, s.data_ptr(),
        sq.data_ptr(), mx.data_ptr(), _build.stream_of(a))
    _build.check(err, "gather_reduce")
    gather_reduce.launches += 1
    if cp != c:
        s, sq, mx = s[..., :c], sq[..., :c], mx[..., :c]
    return s, sq, mx


class _GatherReduce(torch.autograd.Function):
    """K6's launch as an autograd node whose backward raises, so that a
    gradient through the kernel fails loudly instead of losing the gather's
    term (the backward scatter-add kernel is ROADMAP.md queue 1, training)."""

    @staticmethod
    def forward(ctx, a, idx):
        return _gather_reduce_launch(a, idx)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "gather_reduce (K6) has no backward kernel yet: run the CUDA "
            "forward under torch.no_grad(), or differentiate on the CPU")


def gather_reduce(a, idx):
    """K6: the sum, sum of squares and max of a's rows over each row's
    neighbours, a (B, N, C) float32, idx (B, N, K) int64 (out-of-range
    entries clamp within their shape). Returns three (B, N, C). On CUDA, a
    must be contiguous, C <= 256 (padded to a multiple of 32) and K <= 128;
    the sums run over k in ascending order. The CUDA path is forward only:
    backpropagating through it raises NotImplementedError."""
    if a.device.type == "cpu":
        return gather_reduce_plain(a, idx)
    if torch.is_grad_enabled() and a.requires_grad:
        return _GatherReduce.apply(a, idx)
    return _gather_reduce_launch(a, idx)


gather_reduce.launches = 0


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

    s, sq, ext = gather_reduce((a * sign).contiguous(), idx)
    s = s * sign
    ext = ext * sign

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
