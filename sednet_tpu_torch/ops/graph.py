"""Edge convolution of the DGCNN encoder, factored through the gather.

Counterpart of `sednet_tpu/ops/graph.py:17-39,74-141`. The gather and its
three reductions over the neighbours are kernel K6 (`gather_reduce`,
`csrc/gather_reduce.cu`, the counterpart of the TPU probe kernel
`scripts/probe_gather_pallas.py:_call`): a CUDA tensor launches it, a CPU
tensor takes `gather_reduce_plain`. Forward only: the kernel has no
backward yet, and a backward through it raises. The kernel walks the rows
in a given order, a Morton curve of the points (`locality_order`), so that
the rows a block handles share their neighbours and read them from L1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sednet_tpu_torch.ops import _build


def _spread_bits(v):
    """Insert two zero bits between the low 10 bits (Morton spreading)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


_MORTON = {}   # device -> (1024, 3) int32: x, y, z's spread bits in place


def _morton_table(device):
    """The 10-bit Morton codes of one axis value, shifted into place for
    x, y and z, so that a key is one gather and one sum (the three fields
    share no bit; a key has 30 bits)."""
    if device not in _MORTON:
        v = _spread_bits(torch.arange(1024, dtype=torch.int64))
        _MORTON[device] = torch.stack([v, v << 1, v << 2], -1).to(
            device=device, dtype=torch.int32)
    return _MORTON[device]


def locality_order(xyz):
    """Per shape, the permutation that sorts the rows along a Morton curve
    of their points: xyz (B, N, 3) float32 -> (B, N) int32 on xyz's device.
    The port's copy of `sednet_tpu/ops/flash_topk.py:_locality_order` for
    D <= 3: centre, quantise each axis to 10 bits between its min and max,
    interleave the bits, stable argsort of the key.

    Only xyz is taken: the encoder's three graphs (two in feature space)
    share their neighbours along one Morton curve of the points as well as
    along the features' own PCA curve, so the PCA branch of the JAX
    function (D > 3) is not ported and wider rows raise."""
    if xyz.dim() != 3 or not 1 <= xyz.shape[-1] <= 3:
        raise ValueError(f"locality_order: xyz must be (B, N, D <= 3), got "
                         f"{tuple(xyz.shape)}")
    c = xyz - xyz.mean(dim=1, keepdim=True)
    if c.shape[-1] < 3:
        c = F.pad(c, (0, 3 - c.shape[-1]))
    lo, hi = torch.aminmax(c, dim=1, keepdim=True)
    qv = torch.clamp((c - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0,
                     0.0, 1023.0).to(torch.int64)
    table = _morton_table(xyz.device)
    key = table[qv, torch.arange(3, device=xyz.device)].sum(
        -1, dtype=torch.int32)
    return torch.sort(key, dim=1, stable=True).indices.to(torch.int32)


def _check_order(order, a):
    """Raise unless order is a (B, N) int32 tensor on a's device."""
    if (order.dim() != 2 or tuple(order.shape) != tuple(a.shape[:2])
            or order.dtype != torch.int32 or order.device != a.device):
        raise ValueError(
            f"order must be a (B, N) = {tuple(a.shape[:2])} int32 tensor on "
            f"{a.device}, got {tuple(order.shape)} {order.dtype} on "
            f"{order.device}")


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


def _gather_reduce_launch(a, idx, order):
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
    _build.require_row_offsets("gather_reduce", ap)
    if ap.data_ptr() % 16:
        raise ValueError("gather_reduce: a must be 16-byte aligned")
    cp = ap.shape[-1]
    idx = idx.contiguous()
    order = None if order is None else order.contiguous()
    s, sq, mx = (torch.empty((b, n, cp), dtype=torch.float32, device=a.device)
                 for _ in range(3))
    err = _build.lib().sednet_gather_reduce(
        ap.data_ptr(), idx.data_ptr(),
        0 if order is None else order.data_ptr(), b, n, cp, k, s.data_ptr(),
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
    def forward(ctx, a, idx, order):
        return _gather_reduce_launch(a, idx, order)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "gather_reduce (K6) has no backward kernel yet: run the CUDA "
            "forward under torch.no_grad(), or differentiate on the CPU")


def gather_reduce(a, idx, order=None):
    """K6: the sum, sum of squares and max of a's rows over each row's
    neighbours, a (B, N, C) float32, idx (B, N, K) int64 (out-of-range
    entries clamp within their shape). Returns three (B, N, C). On CUDA, a
    must be contiguous, C <= 256 (padded to a multiple of 32) and K <= 128;
    the sums run over k in ascending order. The CUDA path is forward only:
    backpropagating through it raises NotImplementedError.

    order: None (the rows in their own order) or a (B, N) int32 tensor on
    a's device that must hold a permutation of 0 .. N-1 in each shape
    (`locality_order`); the kernel's blocks take consecutive runs of it.
    Every output row is computed the same way whatever the order, so the
    result is the same bits with and without it; the CPU path checks the
    order and ignores it."""
    if order is not None:
        _check_order(order, a)
    if a.device.type == "cpu":
        return gather_reduce_plain(a, idx)
    if torch.is_grad_enabled() and a.requires_grad:
        return _GatherReduce.apply(a, idx, order)
    return _gather_reduce_launch(a, idx, order)


gather_reduce.launches = 0


def edge_conv_factored(x, idx, weight, scale, bias, *, groups: int,
                       negative_slope: float = 0.2, eps: float = 1e-6,
                       order=None):
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

    x: (B, N, C_in), idx: (B, N, K); scale, bias: (C,); order: the row
    order `gather_reduce` walks (None, or a (B, N) int32 permutation per
    shape), which changes no value. Returns (B, N, C).
    """
    c_in = x.shape[-1]
    w_top = weight[:, :c_in]
    a = F.linear(x, w_top)
    bb = F.linear(x, weight[:, c_in:] - w_top)
    sign = torch.where(scale >= 0, 1.0, -1.0)

    s, sq, ext = gather_reduce((a * sign).contiguous(), idx, order)
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
