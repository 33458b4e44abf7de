"""Edge convolution of the DGCNN encoder, factored through the gather.

Counterpart of `sednet_tpu/ops/graph.py:17-39,74-141`. The gather and its
three reductions over the neighbours are kernel K6 (`gather_reduce`,
`csrc/gather_reduce.cu`, the counterpart of the TPU probe kernel
`scripts/probe_gather_pallas.py:_call`): a CUDA tensor launches it, a CPU
tensor takes `gather_reduce_plain`. Its gradient is kernel K6b
(`gather_reduce_backward`, `csrc/gather_reduce_bwd.cu`): on the card a
backward through K6 launches it, on the CPU autograd differentiates the
plain version. The JAX package has no kernel for that gradient: it
differentiates XLA's gather. Both kernels walk the rows in a given order, a
Morton curve of the points (`locality_order`), so that the rows a block
handles share their neighbours.
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


def _check_graph(what, a, idx):
    if a.dim() != 3 or idx.dim() != 3 or idx.shape[:2] != a.shape[:2]:
        raise ValueError(f"{what}: a (B, N, C) and idx (B, N, K)")
    if idx.device != a.device or idx.dtype != torch.int64:
        raise ValueError(f"{what}: idx must be int64 on a's device")
    if not 1 <= idx.shape[2] <= 128:
        raise ValueError(f"{what}: K={idx.shape[2]} outside [1, 128]")


def _kernel_table(what, t):
    """t (B, N, C) float32 on the card, padded to the kernels' width and
    checked for the 32-bit row offsets and 16-byte alignment they take."""
    _build.require_cuda_f32(what, t)
    tp = _build.pad_width(t)
    _build.require_row_offsets(what, tp)
    if tp.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
    return tp


def _gather_reduce_launch(a, idx, order):
    _check_graph("gather_reduce", a, idx)
    b, n, c = a.shape
    ap = _kernel_table("gather_reduce a", a)
    cp = ap.shape[-1]
    idx = idx.contiguous()
    order = None if order is None else order.contiguous()
    s, sq, mx = (torch.empty((b, n, cp), dtype=torch.float32, device=a.device)
                 for _ in range(3))
    err = _build.lib().sednet_gather_reduce(
        ap.data_ptr(), idx.data_ptr(),
        0 if order is None else order.data_ptr(), b, n, cp, idx.shape[2],
        s.data_ptr(), sq.data_ptr(), mx.data_ptr(), _build.stream_of(a))
    _build.check(err, "gather_reduce")
    gather_reduce.launches += 1
    if cp != c:
        s, sq, mx = s[..., :c], sq[..., :c], mx[..., :c]
    return s, sq, mx


class _GatherReduce(torch.autograd.Function):
    """K6's launch as an autograd node whose backward is kernel K6b. It
    keeps the table, the graph, the order and the forward's max, which K6b
    compares each gathered value with to find the max's ties."""

    @staticmethod
    def forward(ctx, a, idx, order):
        s, sq, mx = _gather_reduce_launch(a, idx, order)
        ctx.save_for_backward(a, idx, order, mx)
        return s, sq, mx

    @staticmethod
    def backward(ctx, gs, gsq, gmx):
        a, idx, order, mx = ctx.saved_tensors
        return _gather_reduce_backward_launch(a, idx, order, mx, gs, gsq,
                                              gmx), None, None


def gather_reduce(a, idx, order=None):
    """K6: the sum, sum of squares and max of a's rows over each row's
    neighbours, a (B, N, C) float32, idx (B, N, K) int64 (out-of-range
    entries clamp within their shape). Returns three (B, N, C). On CUDA, a
    must be contiguous, C <= 256 (padded to a multiple of 32) and K <= 128;
    the sums run over k in ascending order. Where a requires grad on CUDA,
    the backward launches K6b (`gather_reduce_backward`); on the CPU
    autograd differentiates `gather_reduce_plain`.

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


def gather_reduce_backward_plain(a, idx, mx, gs, gsq, gmx):
    """Plain PyTorch version of K6b, the gradient of `gather_reduce` with
    respect to a: a (B, N, C) the table, idx (B, N, K), mx (B, N, C) the
    forward's max, gs, gsq, gmx (B, N, C) the cotangents of the sum, the
    sum of squares and the max. Each gathered position (i, k) with
    j = clamp(idx[i, k], 0, N - 1) adds

        gs[i] + 2 a[j] gsq[i] + [a[j] == mx[i]] gmx[i] / cnt[i]

    into da[j], cnt[i] the number of positions of row i equal to its max
    (the max's cotangent split over its ties, as JAX's reduce_max VJP and
    torch's amax backward split it), through the (B, N, K, C) gather and
    `index_add_`."""
    b, n, c = a.shape
    g = gather_neighbors(a, idx)
    tie = g == mx[:, :, None, :]
    cnt = tie.sum(2, dtype=a.dtype)
    w = torch.where(cnt > 0, gmx / cnt.clamp_min(1.0), 0.0)
    d = (gs[:, :, None, :] + 2.0 * g * gsq[:, :, None, :]
         + torch.where(tie, w[:, :, None, :], 0.0))
    flat = idx.clamp(0, n - 1) + n * torch.arange(
        b, device=a.device, dtype=idx.dtype)[:, None, None]
    da = torch.zeros((b * n, c), dtype=a.dtype, device=a.device)
    da.index_add_(0, flat.reshape(-1), d.reshape(-1, c))
    return da.reshape(b, n, c)


def _gather_reduce_backward_launch(a, idx, order, mx, gs, gsq, gmx):
    _check_graph("gather_reduce_backward", a, idx)
    if order is not None:
        _check_order(order, a)
    b, n, c = a.shape
    ap, mxp, gsp, gsqp, gmxp = (
        _kernel_table(f"gather_reduce_backward {name}", t.contiguous())
        for name, t in (("a", a), ("mx", mx), ("gs", gs), ("gsq", gsq),
                        ("gmx", gmx)))
    if any(t.shape != ap.shape for t in (mxp, gsp, gsqp, gmxp)):
        raise ValueError("gather_reduce_backward: a, mx, gs, gsq and gmx "
                         "must all be (B, N, C)")
    cp = ap.shape[-1]
    idx = idx.contiguous()
    order = None if order is None else order.contiguous()
    da = torch.zeros((b, n, cp), dtype=torch.float32, device=a.device)
    err = _build.lib().sednet_gather_reduce_backward(
        ap.data_ptr(), idx.data_ptr(),
        0 if order is None else order.data_ptr(), mxp.data_ptr(),
        gsp.data_ptr(), gsqp.data_ptr(), gmxp.data_ptr(), b, n, cp,
        idx.shape[2], da.data_ptr(), _build.stream_of(a))
    _build.check(err, "gather_reduce_backward")
    gather_reduce_backward.launches += 1
    return da if cp == c else da[..., :c]


def gather_reduce_backward(a, idx, mx, gs, gsq, gmx, order=None):
    """K6b: the gradient of `gather_reduce(a, idx)` with respect to a, given
    the forward's max mx and the cotangents gs, gsq, gmx (each (B, N, C));
    see `gather_reduce_backward_plain` for the formula. A CUDA tensor
    launches the kernel, whose atomic adds make the last bits vary from run
    to run (`backward_error_bound` bounds its distance from the plain
    version); a CPU tensor takes the plain version. order: as in
    `gather_reduce`, the row order the kernel's blocks walk."""
    if a.device.type == "cpu":
        if order is not None:
            _check_order(order, a)
        return gather_reduce_backward_plain(a, idx, mx, gs, gsq, gmx)
    return _gather_reduce_backward_launch(a, idx, order, mx, gs, gsq, gmx)


gather_reduce_backward.launches = 0


def backward_error_bound(a, idx, mx, gs, gsq, gmx):
    """Per element of da (B, N, C), the most that two float32 evaluations of
    `gather_reduce_backward_plain`'s sums may differ by when they add the
    same terms in any two orders: (2 m + 4) u S, with m the number of terms
    the element sums (the row's in-degree), S the sum of their magnitudes
    and u = 2^-24 (each order's error is at most m u S; the terms themselves
    round a few units apart)."""
    b, n, c = a.shape
    g = gather_neighbors(a, idx)
    tie = g == mx[:, :, None, :]
    cnt = tie.sum(2, dtype=a.dtype).clamp_min(1.0)
    d = (gs[:, :, None, :].abs() + 2.0 * g.abs() * gsq[:, :, None, :].abs()
         + torch.where(tie, (gmx / cnt).abs()[:, :, None, :], 0.0))
    flat = (idx.clamp(0, n - 1) + n * torch.arange(
        b, device=a.device, dtype=idx.dtype)[:, None, None]).reshape(-1)
    mag = torch.zeros((b * n, c), dtype=torch.float64, device=a.device)
    mag.index_add_(0, flat, d.reshape(-1, c).double())
    deg = torch.bincount(flat, minlength=b * n).double()[:, None]
    return ((2.0 * deg + 4.0) * 2.0 ** -24 * mag).reshape(b, n, c)


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
