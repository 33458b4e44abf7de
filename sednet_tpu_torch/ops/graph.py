"""Edge convolution of the DGCNN encoder, factored through the gather.

Counterpart of `sednet_tpu/ops/graph.py:17-39,74-141`. The gather and its
three reductions over the neighbours are kernel K6 (`gather_reduce`,
`csrc/gather_reduce.cu`, the counterpart of the TPU probe kernel
`scripts/probe_gather_pallas.py:_call`), the `torch.library` op
`sednet::gather_reduce`: a CUDA tensor launches it, a CPU tensor takes
`gather_reduce_plain`. Its gradient is kernel K6b
(`gather_reduce_backward`, `csrc/gather_reduce_bwd.cu`), the op
`sednet::gather_reduce_backward` that K6's autograd formula calls: on the
card a backward through K6 launches it, on the CPU it takes
`gather_reduce_backward_plain`. K6b sums each row of the gradient over the
graph's transpose (`graph_transpose`) in an order the graph alone fixes,
with no float atomics: the same bits on every launch and under every row
order, the bits of the plain version run on the CPU. The JAX package has
no kernel for that gradient: it differentiates XLA's gather. As ops, both
trace under `torch.export` into calls in the exported graph. Both kernels
walk the rows in a given order, a Morton curve of the points
(`locality_order`), so that the rows a block handles share their
neighbours.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sednet_tpu_torch.ops import _build


def _spread_bits(v):
    """Insert two zero bits between the low 10 bits (Morton spreading)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def locality_order(x, axes=None):
    """Per shape, the permutation that sorts the rows along a Morton curve:
    x (B, N, D) float32 -> (B, N) int32 on x's device. The port's copy of
    `sednet_tpu/ops/flash_topk.py:_locality_order`: centre; for D > 3 take
    the top-3 principal axes of the centred rows (the float32 covariance's
    last three eigenvectors, `torch.linalg.eigh`) as the coordinates, for
    D < 3 pad with zeros; quantise each axis to 10 bits between its min
    and max, interleave the bits, stable argsort of the key.

    Eigenvector signs and near-equal eigenvalues may change the PCA order
    from JAX's; no result of the kernels depends on the order. axes: the
    (B, D, 3) principal axes to project on instead of eigh's (a caller
    that fixes their signs)."""
    if x.dim() != 3 or x.shape[-1] < 1:
        raise ValueError(f"locality_order: x must be (B, N, D), got "
                         f"{tuple(x.shape)}")
    c = x - x.mean(dim=1, keepdim=True)
    if c.shape[-1] > 3:
        if axes is None:
            cov = (c.transpose(1, 2) @ c).float()
            axes = torch.linalg.eigh(cov).eigenvectors[..., -3:]  # ascending
        c = c @ axes.to(c.dtype)
    elif c.shape[-1] < 3:
        c = F.pad(c, (0, 3 - c.shape[-1]))
    lo, hi = torch.aminmax(c, dim=1, keepdim=True)
    qv = torch.clamp((c - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0,
                     0.0, 1023.0).to(torch.int64)
    # x, y and z's spread bits shifted into place: the three fields share
    # no bit, so the sum is the 30-bit interleave. Computed in the call, not
    # cached, so that an export's fake tensors never enter a cache.
    key = (_spread_bits(qv) << torch.arange(3, device=x.device)).sum(
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


def edge_features(x, idx):
    """[x_j - x_i, x_i] edge features (`sednet_tpu/ops/graph.py:40-48`):
    x (B, N, C), idx (B, N, K) -> (B, N, K, 2C)."""
    nbr = gather_neighbors(x, idx)
    ctr = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


def edge_conv_features(x, idx, weight):
    """conv([x_j - x_i, x_i]) with the bias-free 1x1 conv `weight` (C',
    2C) factored through the gather, at JAX's rounding points
    (`sednet_tpu/ops/graph.py:51-71`): a = conv([x, 0]) and
    b = conv([-x, x]), each one product in x's dtype, then gather(a) + b.
    x and weight share a dtype (bf16 under `model_bf16`).
    Returns (B, N, K, C')."""
    a = F.linear(torch.cat([x, torch.zeros_like(x)], dim=-1), weight)
    b = F.linear(torch.cat([-x, x], dim=-1), weight)
    return gather_neighbors(a, idx) + b[:, :, None, :]


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
    return _unpad(s, c), _unpad(sq, c), _unpad(mx, c)


def _unpad(t, c):
    """The first c columns of a kernel output, contiguous, as the op's fake
    implementation states them."""
    return t if t.shape[-1] == c else t[..., :c].contiguous()


# K6 and K6b as the custom ops `sednet::gather_reduce` and
# `sednet::gather_reduce_backward`: the dispatcher sends CUDA tensors to the
# kernels and CPU tensors to the plain versions; any other device has no
# implementation and raises. K6's autograd formula is K6b's op on either
# device.
@torch.library.custom_op("sednet::gather_reduce", mutates_args=(),
                         device_types="cpu")
def _gather_reduce_op(a: torch.Tensor, idx: torch.Tensor,
                      order: Optional[torch.Tensor]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return gather_reduce_plain(a, idx)


_gather_reduce_op.register_kernel("cuda")(_gather_reduce_launch)


@_gather_reduce_op.register_fake
def _(a, idx, order):
    return tuple(torch.empty_like(a, memory_format=torch.contiguous_format)
                 for _ in range(3))


def _gather_reduce_setup(ctx, inputs, output):
    a, idx, order = inputs
    ctx.save_for_backward(a, idx, order, output[2])


def _gather_reduce_grad(ctx, gs, gsq, gmx):
    a, idx, order, mx = ctx.saved_tensors
    da = torch.ops.sednet.gather_reduce_backward(
        a, idx, order, mx, gs.contiguous(), gsq.contiguous(),
        gmx.contiguous())
    return da, None, None


torch.library.register_autograd("sednet::gather_reduce", _gather_reduce_grad,
                                setup_context=_gather_reduce_setup)


def gather_reduce(a, idx, order=None):
    """K6: the sum, sum of squares and max of a's rows over each row's
    neighbours, a (B, N, C) float32, idx (B, N, K) int64 (out-of-range
    entries clamp within their shape). Returns three (B, N, C). Through the
    op `sednet::gather_reduce` (`torch.ops.sednet.gather_reduce`): on CUDA,
    a must be contiguous, C <= 256 (padded to a multiple of 32) and K <=
    128; the sums run over k in ascending order. The op's gradient is K6b
    (`gather_reduce_backward`), on the card and on the CPU.

    order: None (the rows in their own order) or a (B, N) int32 tensor on
    a's device that must hold a permutation of 0 .. N-1 in each shape
    (`locality_order`); the kernel's blocks take consecutive runs of it.
    Every output row is computed the same way whatever the order, so the
    result is the same bits with and without it; the CPU path checks the
    order and ignores it."""
    if order is not None:
        _check_order(order, a)
    return torch.ops.sednet.gather_reduce(a, idx, order)


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
    `index_add_`. On the CPU `index_add_` adds in ascending index order, so
    each da[j] is a sequential sum from +0 of its terms in ascending
    position (b N + i) K + k, the order of `graph_transpose`'s lists: the
    sum K6b computes for every destination."""
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


def graph_transpose(idx, n: int):
    """The transpose of a kNN graph idx (B, N, K) int64 (entries clamped
    into [0, N) within their shape): the edges e = (b N + i) K + k sorted
    by their destination b N + clamp(idx[b, i, k]) with a stable sort, so
    that each destination's edges stand in ascending e. Returns (ends
    (B N,) int32, the inclusive end of each destination's edges, the
    cumsum of the in-degree; eids (B N K,) int32, the edge ids in sorted
    order), on idx's device. A CUDA tensor takes K6b's transpose
    (`csrc/gather_reduce_bwd.cu` sednet_graph_transpose: CUB's stable
    radix sort on the bits of B N - 1 alone), a CPU tensor
    `graph_transpose_plain`; both give the same arrays."""
    _check_transpose(idx, n)
    if idx.is_cuda:
        return _transpose_launch(idx, n)
    return graph_transpose_plain(idx, n)


def _check_transpose(idx, n):
    b, rows, k = idx.shape
    if rows != n or b * n * k >= 2 ** 31 or idx.dtype != torch.int64:
        raise ValueError(f"graph_transpose: idx {tuple(idx.shape)} "
                         f"{idx.dtype} for N={n} (int64, B N K below 2^31)")


def graph_transpose_plain(idx, n: int):
    """`graph_transpose` in plain PyTorch: the flat destinations, torch's
    stable sort, and the ends by a search in the sorted keys (not a
    bincount, which would read the largest key back to the host)."""
    b = idx.shape[0]
    dest = (idx.clamp(0, n - 1) + n * torch.arange(
        b, device=idx.device, dtype=idx.dtype)[:, None, None]).reshape(-1)
    keys, eids = torch.sort(dest.to(torch.int32), stable=True)
    ends = torch.searchsorted(
        keys, torch.arange(b * n, device=idx.device, dtype=torch.int32),
        right=True, out_int32=True)
    return ends, eids.to(torch.int32)


def _transpose_launch(idx, n):
    """K6b's transpose on the card: (ends, eids)."""
    b, _, k = idx.shape
    idx = idx.contiguous()
    lib = _build.lib()
    nbytes = lib.sednet_graph_transpose_scratch(b * n * k, b * n)
    dev = idx.device
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    ends = torch.empty(b * n, dtype=torch.int32, device=dev)
    eids = torch.empty(b * n * k, dtype=torch.int32, device=dev)
    err = lib.sednet_graph_transpose(
        idx.data_ptr(), b, n, k, scratch.data_ptr(), nbytes, ends.data_ptr(),
        eids.data_ptr(), _build.stream_of(idx))
    _build.check(err, "graph_transpose")
    return ends, eids


def _gather_reduce_backward_launch(a, idx, order, mx, gs, gsq, gmx):
    _check_graph("gather_reduce_backward", a, idx)
    if order is not None:
        _check_order(order, a)
    b, n, c = a.shape
    k = idx.shape[2]
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
    _check_transpose(idx, n)
    ends, eids = _transpose_launch(idx, n)
    dev = a.device
    mask = torch.empty(eids.numel() * cp // 32, dtype=torch.int32, device=dev)
    w = torch.empty((b, n, cp), dtype=torch.float32, device=dev)
    da = torch.empty((b, n, cp), dtype=torch.float32, device=dev)
    err = _build.lib().sednet_gather_reduce_backward(
        ap.data_ptr(), idx.data_ptr(),
        0 if order is None else order.data_ptr(), mxp.data_ptr(),
        gsp.data_ptr(), gsqp.data_ptr(), gmxp.data_ptr(), ends.data_ptr(),
        eids.data_ptr(), b, n, cp, k, mask.data_ptr(), w.data_ptr(),
        da.data_ptr(), _build.stream_of(a))
    _build.check(err, "gather_reduce_backward")
    gather_reduce_backward.launches += 1
    return _unpad(da, c)


@torch.library.custom_op("sednet::gather_reduce_backward", mutates_args=(),
                         device_types="cpu")
def _gather_reduce_backward_op(a: torch.Tensor, idx: torch.Tensor,
                               order: Optional[torch.Tensor],
                               mx: torch.Tensor, gs: torch.Tensor,
                               gsq: torch.Tensor,
                               gmx: torch.Tensor) -> torch.Tensor:
    return gather_reduce_backward_plain(a, idx, mx, gs, gsq, gmx)


_gather_reduce_backward_op.register_kernel("cuda")(
    _gather_reduce_backward_launch)


@_gather_reduce_backward_op.register_fake
def _(a, idx, order, mx, gs, gsq, gmx):
    return torch.empty_like(a, memory_format=torch.contiguous_format)


def gather_reduce_backward(a, idx, mx, gs, gsq, gmx, order=None):
    """K6b: the gradient of `gather_reduce(a, idx)` with respect to a, given
    the forward's max mx and the cotangents gs, gsq, gmx (each (B, N, C));
    see `gather_reduce_backward_plain` for the formula. Through the op
    `sednet::gather_reduce_backward`: a CUDA tensor launches the kernel,
    which sums each row of da over the graph's transpose in a fixed order
    and gives the same bits on every launch and under every order: those
    of the plain version run on the CPU. A CPU tensor takes the plain
    version. order: as in `gather_reduce`, the row order the kernel's
    blocks walk."""
    if order is not None:
        _check_order(order, a)
    return torch.ops.sednet.gather_reduce_backward(a, idx, order, mx, gs,
                                                   gsq, gmx)


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
