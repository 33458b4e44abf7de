"""Index-free fused DGCNN edge convolution (kernel K4, `csrc/fused_edgeconv.cu`).

Counterpart of `sednet_tpu/ops/fused_edgeconv.py` (inference only). The
neighbour set of point i is { j : d(i, j) <= T_i }, T_i its k-th smallest
distance (self included; every tie with T_i joins, and the count says how
many did). `fused_edge_reductions` returns the per-channel max, sum and sum
of squares of `a` over that set, and its size; `fused_edge_conv` rebuilds the
edge convolution's output from them without the (B, N, K, C) gathered
tensor, and `encoder_apply_fused` runs the DGCNN encoder's three edge
convolutions that way on the same parameters.

A CUDA tensor launches the kernel; a CPU tensor takes
`fused_edge_reductions_plain`. The kernel selects each row's k nearest
columns as K1 does (`flash_topk`, the same walk and distance bits), with a
flag where a column outside them ties the k-th distance, reduces over the
k columns as K6 does (`graph.gather_reduce`), and rescans the flagged rows
for their tied columns; on a row without a tie its output is the index
route's bit for bit. The reduction walks the rows along the caller's order
(`graph.locality_order`, a Morton curve of the points), as K6 does, which
changes no value. The TPU wrapper's Morton `spatial_sort` of the distance
walk only speeds that kernel's tile skip and changes no value; it is not
ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sednet_tpu_torch.ops import _build
from sednet_tpu_torch.ops.flash_topk import (D_MAX, K_MAX, METRICS,
                                             _dist_plain, topk_plain)
from sednet_tpu_torch.ops.graph import _check_order, locality_order


def fused_edge_reductions_plain(geom, a, k: int, *, metric: str = "sqdist",
                                normal_metric_w: float = 1.0,
                                row_block: int = 1024):
    """Plain PyTorch version, row-blocked over a dense mask: the distance
    block with K1's expansion (`flash_topk._dist_plain`), T = its k-th
    smallest value per row, mask d <= T; sum, sum of squares and count as
    mask products, the max over the candidates of the smallest
    max-count distances of the block.

    geom: (N, D) or (B, N, D); a: (N, C) or (B, N, C). Returns (mx, sm, sq
    (..., N, C), cnt (..., N) float32)."""
    squeeze = geom.dim() == 2
    gb, ab = (geom[None], a[None]) if squeeze else (geom, a)
    outs = []
    for b in range(gb.shape[0]):
        g, av = gb[b], ab[b]
        parts = []
        for r0 in range(0, g.shape[0], row_block):
            d = _dist_plain(g[r0:r0 + row_block], g, metric, normal_metric_w)
            t = torch.kthvalue(d, k, dim=1).values[:, None]
            m = (d <= t).to(av.dtype)
            cnt = m.sum(1)
            kk = int(cnt.max())
            near, idx = torch.topk(d, kk, dim=1, largest=False)
            cand = torch.where((near <= t)[..., None], av[idx],
                               torch.tensor(float("-inf"), dtype=av.dtype,
                                            device=av.device))
            parts.append((cand.amax(1), m @ av, m @ (av * av), cnt))
        outs.append([torch.cat(p) for p in zip(*parts)])
    res = [torch.stack(p) for p in zip(*outs)]
    return tuple(r[0] for r in res) if squeeze else tuple(res)


def compare_with_plain(geom, a, k, out, *, metric: str = "sqdist",
                       normal_metric_w: float = 1.0):
    """Hold a result out = (mx, sm, sq, cnt) against
    `fused_edge_reductions_plain` on the same inputs. Two float32 orders of
    summation can move a distance that ties the k-th one across the
    threshold (a neighbour joins, leaves or is swapped), so, with K1's
    rounding scale s (`flash_topk.compare_with_plain`), a row agrees when
    its count is equal, its maxima are equal (the max of the same
    elements) and its sums and sums of squares are within
    1e-5 * k * max|a| (and max|a|^2), the reassociation bound of a sum of
    about k terms; every row whose plain k-th and (k+1)-th distances are
    more than 1e-6 * s apart must agree.

    Returns {"bad_rows": rows that disagree outside a near-tie,
    "tie_rows": near-tie rows, "swapped_rows": rows that disagree, "rows",
    "mx_err", "sm_err", "sq_err": over the rows outside near-ties,
    "sum_tol", "sq_tol", "max_abs_err": the largest of the three}."""
    mx, sm, sq, cnt = out
    pmx, psm, psq, pcnt = fused_edge_reductions_plain(
        geom, a, k, metric=metric, normal_metric_w=normal_metric_w)
    dp, _ = topk_plain(geom, geom, k + 1, metric=metric,
                       normal_metric_w=normal_metric_w)
    sg = geom[..., :3] if metric == "points_normals" else geom
    scale = (1.0 + float((sg * sg).sum(-1).max())) * (
        1.0 + 4.0 * abs(normal_metric_w) if metric == "points_normals"
        else 1.0)
    near_tie = (dp[..., k] - dp[..., k - 1]).abs() <= 1e-6 * scale
    amax = float(a.abs().max())
    sum_tol, sq_tol = 1e-5 * k * amax, 1e-5 * k * amax * amax
    rows = [(x - y).abs().amax(-1) for x, y in ((mx, pmx), (sm, psm),
                                                 (sq, psq))]
    agree = ((cnt == pcnt) & (rows[0] == 0) & (rows[1] <= sum_tol)
             & (rows[2] <= sq_tol))
    firm = ~near_tie
    errs = [float(r[firm].max()) if bool(firm.any()) else 0.0 for r in rows]
    return {"bad_rows": int((~agree & firm).sum()),
            "tie_rows": int(near_tie.sum()),
            "swapped_rows": int((~agree).sum()), "rows": agree.numel(),
            "mx_err": errs[0], "sm_err": errs[1], "sq_err": errs[2],
            "sum_tol": sum_tol, "sq_tol": sq_tol, "max_abs_err": max(errs)}


def _launch(geom, a, k, metric, w, order):
    _build.require_cuda_f32("fused_edge_reductions geom", geom)
    _build.require_cuda_f32("fused_edge_reductions a", a)
    if geom.device != a.device or geom.dim() != 3 or a.dim() != 3:
        raise ValueError("fused_edge_reductions: geom (B, N, D) and a "
                         "(B, N, C) on one device")
    batch, n, d = geom.shape
    if a.shape[:2] != (batch, n):
        raise ValueError("fused_edge_reductions: geom and a differ in B, N")
    if not 1 <= k <= min(K_MAX, n):
        raise ValueError(f"fused_edge_reductions: k={k} outside "
                         f"[1, min({K_MAX}, {n})]")
    if d > D_MAX or (metric == "points_normals" and d < 6):
        raise ValueError(f"fused_edge_reductions: width {d} not supported "
                         f"for {metric}")
    c = a.shape[-1]
    ap = _build.pad_width(a)
    _build.require_row_offsets("fused_edge_reductions", ap)
    if ap.data_ptr() % 16:
        raise ValueError("fused_edge_reductions: a must be 16-byte aligned")
    cp = ap.shape[-1]
    dev = geom.device
    cols = torch.empty((batch, n, k), dtype=torch.int32, device=dev)
    kth = torch.empty((batch, n), dtype=torch.float32, device=dev)
    tie = torch.empty((batch, n), dtype=torch.int32, device=dev)
    mx, sm, sq = (torch.empty((batch, n, cp), dtype=torch.float32, device=dev)
                  for _ in range(3))
    cnt = torch.empty((batch, n), dtype=torch.float32, device=dev)
    order = None if order is None else order.contiguous()
    err = _build.lib().sednet_fused_edge_reductions(
        geom.data_ptr(), ap.data_ptr(),
        0 if order is None else order.data_ptr(), batch, n, d, cp, k,
        METRICS.index(metric), float(w), cols.data_ptr(), kth.data_ptr(),
        tie.data_ptr(), mx.data_ptr(), sm.data_ptr(), sq.data_ptr(),
        cnt.data_ptr(), _build.stream_of(geom))
    _build.check(err, "fused_edge_reductions")
    fused_edge_reductions.launches += 1
    if cp != c:
        mx, sm, sq = mx[..., :c], sm[..., :c], sq[..., :c]
    return mx, sm, sq, cnt


def fused_edge_reductions(geom, a, k: int, *, metric: str = "sqdist",
                          normal_metric_w: float = 1.0, order=None):
    """Neighbour-set reductions of `a` under the self-kNN of `geom` (K4,
    `fused_edge_reductions`): (mx, sm, sq, cnt), see the module docstring.

    geom: (N, D) or (B, N, D); a: (N, C) or (B, N, C). On CUDA both must be
    contiguous float32, k <= 128, D <= 256 and C <= 256. order: None or the
    row order of the reduction, (N,) or (B, N) int32 as geom is batched,
    which must be a permutation of each shape's rows (`gather_reduce`); it
    changes no value, and the CPU path checks it and ignores it."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    squeeze = geom.dim() == 2
    if order is not None:
        _check_order(order[None] if squeeze else order,
                     a[None] if squeeze else a)
    if geom.device.type == "cpu":
        return fused_edge_reductions_plain(geom, a, k, metric=metric,
                                           normal_metric_w=normal_metric_w)
    if squeeze:
        out = _launch(geom[None], a[None], k, metric, normal_metric_w,
                      None if order is None else order[None])
        return tuple(o[0] for o in out)
    return _launch(geom, a, k, metric, normal_metric_w, order)


fused_edge_reductions.launches = 0


def fused_edge_conv(x, geom, weight, scale, bias, k: int, *, groups: int,
                    metric: str = "sqdist", normal_metric_w: float = 1.0,
                    eps: float = 1e-6, negative_slope: float = 0.2,
                    order=None):
    """One edge convolution, index-free (inference only).

    x: (B, N, C_in) layer input; geom: (B, N, D) the kNN metric rows (x
    itself for feature-space layers, xyz ++ normals for layer 1); weight:
    (C, 2*C_in) the bias-free 1x1 conv over [x_j - x_i, x_i]; scale, bias:
    (C,) GroupNorm. With a = x W_top^T and bb = x (W_bot - W_top)^T the
    edge feature is a[j] + bb[i]; its GroupNorm statistics follow from the
    reductions of sign(scale) * a with the data-dependent count
    sum(cnt) * gsz per shape (ties add items), mean of squares minus
    squared mean, eps inside the rsqrt. GroupNorm affine plus LeakyReLU is
    monotone per channel in the direction of sign(scale), so the signed
    max is the extremum the channel needs. order: the reduction's row
    order (`fused_edge_reductions`). Returns (B, N, C)."""
    squeeze = x.dim() == 2
    if squeeze:
        x, geom = x[None], geom[None]
        order = None if order is None else order[None]
    c_in = x.shape[-1]
    w_top = weight[:, :c_in]
    a = F.linear(x, w_top)
    bb = F.linear(x, weight[:, c_in:] - w_top)
    sign = torch.where(scale >= 0, 1.0, -1.0)

    mxs, sms, sq, cnt = fused_edge_reductions(
        geom.contiguous(), (a * sign).contiguous(), k, metric=metric,
        normal_metric_w=normal_metric_w, order=order)
    gext = sign * mxs
    gsum = sign * sms
    cnt = cnt[..., None]

    b, n, c = a.shape
    gsz = c // groups

    def grp(v):
        return v.reshape(b, n, groups, gsz)

    tot = (cnt.sum(dim=(1, 2)) * gsz)[:, None]             # (B, 1)
    sum_g = grp(gsum + cnt * bb).sum(dim=(1, 3))
    sumsq_g = grp(sq + 2.0 * bb * gsum + cnt * bb * bb).sum(dim=(1, 3))
    mean = sum_g / tot
    var = torch.clamp_min(sumsq_g / tot - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps)

    mean_c = mean.repeat_interleave(gsz, dim=1)[:, None, :]
    mul_c = mul.repeat_interleave(gsz, dim=1)[:, None, :]
    y = (gext + bb - mean_c) * mul_c * scale + bias
    y = F.leaky_relu(y, negative_slope)
    return y[0] if squeeze else y


@torch.no_grad()
def encoder_apply_fused(encoder, x):
    """The DGCNN encoder's forward through `fused_edge_conv`, on the same
    parameters (`models.backbone.DGCNNEncoder`): x (B, N, 6) in mode 5 or
    (B, N, 3) in mode 0. Returns (global (B, 1024), per-point features
    (B, N, 256)), with every GroupNorm's statistics per shape. One Morton
    order of the points serves the three layers' reductions."""
    x = x.contiguous()
    metric1 = "points_normals" if encoder.mode == 5 else "sqdist"
    order = locality_order(x[..., :3])

    def layer(conv, feats, metric):
        return fused_edge_conv(
            feats, feats, conv.conv.weight, conv.gn.weight, conv.gn.bias,
            encoder.k, groups=conv.gn.groups, metric=metric,
            normal_metric_w=encoder.normal_metric_w,
            negative_slope=conv.negative_slope, order=order)

    x1 = layer(encoder.conv1, x, metric1)
    x2 = layer(encoder.conv2, x1, "sqdist")
    x3 = layer(encoder.conv3, x2, "sqdist")
    feats = torch.cat([x1, x2, x3], dim=-1)
    h = F.relu(encoder.gn_mlp1(encoder.mlp1(feats)))
    return h.amax(dim=1), feats
