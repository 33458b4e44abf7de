"""Mean-shift step (kernels K2/K2b), NMS column-max (kernel K3) and the
sorted segment sum (kernel K5).

Counterparts of `sednet_tpu/ops/pallas_kernels.py`:

  * `mean_shift_step` / `mean_shift_step_batched` -- `mean_shift_step_pallas`
    and `mean_shift_step_pallas_batched`. One CUDA kernel with a batch grid
    axis (`csrc/mean_shift.cu`) serves both, and its bf16 twin
    (`csrc/mean_shift_bf16.cu`: wgmma on TMA-fed tiles) their `bf16=True`
    branch; each wrapper counts its own launches (`launches`,
    `launches_bf16`).
  * `colmax` -- `colmax_pallas` (`csrc/colmax.cu`).
  * `segsum_sorted_scan` -- `segsum_sorted_scan_pallas` (`csrc/segsum.cu`):
    per-destination sums of entries sorted by destination, the A^T v of the
    matrix-free spectral solver (`cluster/spectral.py`).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
beside it. The kernels are compiled for row widths that are multiples of 32
up to 256, the bf16 step's for multiples of 16 (its products are 16 deep),
as the TPU kernels take any width; other widths are padded with zero
columns up to the next such multiple (the 140-d HPNet-enriched embedding
runs at 160, at 144 in the bf16 step), which change neither a dot product
nor a norm. A loop of steps pads once (`kernel_width`) so that no step
copies. K5 takes any row count.
"""
from __future__ import annotations

import torch

from sednet_tpu_torch.ops import _build


def kernel_width(x, bf16: bool = False):
    """x (..., E) on a CUDA device zero-padded once to the width the
    kernels run at (`_build.pad_width`: a multiple of 32, or of 16 for the
    bf16 mean-shift step under bf16=True); a CPU tensor as it is, since
    the plain versions take any width. A mean-shift step keeps zero columns
    zero, so a loop runs at this width and slices once at its end."""
    if not x.is_cuda:
        return x
    return _build.pad_width(x, _build.BF16_WIDTH_STEP if bf16
                            else _build.WIDTH_STEP)


def mean_shift_step_plain(new_x, x, inv_b2, row_block: int = 2048,
                          bf16: bool = False):
    """Plain PyTorch version: new_x (B, M, E) rows against x (B, N, E)
    (M = N for a whole shape's step); inv_b2 (B,) = 1/b^2.

        k = exp(max((new_x . x - 1) * inv_b2, -75))
        out = rownorm((k @ x) / max(k.1, 1e-30)),  norm eps 1e-24

    bf16=True does the roundings of the Pallas body with bf16 tile inputs
    (`ops/pallas_kernels.py` with dt = bfloat16) in the inputs' own type:
    new_x and x rounded to bf16 (round to nearest even) for both products,
    k summed before it is rounded to bf16 for k @ x. Given float64 inputs
    it gives the same function in float64."""
    out = torch.empty_like(new_x)
    if bf16:
        new_x, x = (t.to(torch.bfloat16).to(t.dtype) for t in (new_x, x))
    for b in range(x.shape[0]):
        for r0 in range(0, new_x.shape[1], row_block):
            s = new_x[b, r0:r0 + row_block] @ x[b].T
            k = torch.exp(torch.clamp_min((s - 1.0) * inv_b2[b], -75.0))
            den = k.sum(1, keepdim=True)
            if bf16:
                k = k.to(torch.bfloat16).to(x.dtype)
            o = (k @ x[b]) / torch.clamp_min(den, 1e-30)
            nrm = torch.sqrt(torch.clamp_min((o * o).sum(1, keepdim=True),
                                             1e-24))
            out[b, r0:r0 + row_block] = o / nrm
    return out


def step_columns(x, bf16: bool = False):
    """x (..., E) as a loop of mean-shift steps hands it to every step as
    the columns: under bf16 on a CUDA device its bf16 rounding, made once
    for the loop (the bf16 kernel reads bf16 columns, and x does not change
    between steps); otherwise x itself (the CPU's plain version rounds it
    at each step)."""
    return x.to(torch.bfloat16) if bf16 and x.is_cuda else x


def _ms_launch(new_x, x, inv_b2, bf16):
    _build.require_cuda_f32("mean_shift_step new_x", new_x)
    if not bf16:
        _build.require_cuda_f32("mean_shift_step x", x)
    elif (x.dtype != torch.bfloat16 or not x.is_cuda
          or not x.is_contiguous()):
        raise ValueError("mean_shift_step x: under bf16 the contiguous bf16 "
                         "columns of `step_columns` on a CUDA device, got "
                         f"{x.dtype} on {x.device} "
                         f"(contiguous={x.is_contiguous()})")
    if (x.dim() != 3 or new_x.dim() != 3 or new_x.shape[0] != x.shape[0]
            or new_x.shape[2] != x.shape[2]
            or (bf16 and new_x.shape[1] != x.shape[1])):
        raise ValueError("mean_shift_step: new_x (B, M, E) and x (B, N, E), "
                         "M = N under bf16")
    e = x.shape[-1]
    q, xp = kernel_width(new_x, bf16), kernel_width(x, bf16)
    inv_b2 = inv_b2.to(device=x.device, dtype=torch.float32).reshape(-1)
    inv_b2 = inv_b2.contiguous()
    if inv_b2.shape[0] != x.shape[0]:
        raise ValueError("mean_shift_step: one bandwidth per shape")
    out = torch.empty_like(q)
    lib = _build.lib()
    if bf16:
        # the query's cast of the Pallas wrapper (astype(bfloat16)), x's
        # made once a loop; the kernel reads bf16 tiles and writes float32
        q = q.to(torch.bfloat16)
        err = lib.sednet_mean_shift_step_bf16(
            q.data_ptr(), xp.data_ptr(), inv_b2.data_ptr(), x.shape[0],
            x.shape[1], q.shape[-1], out.data_ptr(), _build.stream_of(x))
    else:
        err = lib.sednet_mean_shift_step(
            q.data_ptr(), xp.data_ptr(), inv_b2.data_ptr(), x.shape[0],
            new_x.shape[1], x.shape[1], q.shape[-1], out.data_ptr(),
            _build.stream_of(x))
    _build.check(err, "mean_shift_step")
    return out if q.shape[-1] == e else out[..., :e].contiguous()


def _inv_b2(bandwidth, like):
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=like.device)
    return 1.0 / (bw * bw)


def _count(fn, bf16):
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def mean_shift_step(new_x, x, bandwidth, bf16: bool = False):
    """One mean-shift update of one shape: new_x (M, E) rows against x
    (N, E) unit rows (M = N but for the sharded shift's row shards, float32
    only), bandwidth a scalar (K2, `mean_shift_step_pallas`). bf16=True runs both
    tile products on bf16 inputs with float32 sums (`csrc/mean_shift_bf16.cu`,
    the Pallas kernel's `bf16=True`; counted in `launches_bf16`); on a
    CUDA device x is then the bf16 columns of `step_columns`, made once a
    loop (a float32 x raises there)."""
    inv_b2 = _inv_b2(bandwidth, x).reshape(1)
    if x.device.type == "cpu":
        return mean_shift_step_plain(new_x[None], x[None], inv_b2,
                                     bf16=bf16)[0]
    out = _ms_launch(new_x[None], x[None], inv_b2, bf16)[0]
    _count(mean_shift_step, bf16)
    return out


def mean_shift_step_batched(new_x, x, bandwidth, bf16: bool = False):
    """Batched update: new_x, x (B, N, E), bandwidth (B,) (K2b,
    `mean_shift_step_pallas_batched`); bf16 as in `mean_shift_step`."""
    inv_b2 = _inv_b2(bandwidth, x).reshape(-1)
    if x.device.type == "cpu":
        return mean_shift_step_plain(new_x, x, inv_b2, bf16=bf16)
    out = _ms_launch(new_x, x, inv_b2, bf16)
    _count(mean_shift_step_batched, bf16)
    return out


mean_shift_step.launches = mean_shift_step.launches_bf16 = 0
mean_shift_step_batched.launches = mean_shift_step_batched.launches_bf16 = 0


def colmax_plain(rows, cols, bias, thresh: float, gain: float,
                 row_block: int = 2048):
    """Plain PyTorch version of the NMS column-max: for every row,
    (max_c scored, lowest c attaining it) with
        scored = gain*sim + bias[c] where 2 - 2*sim < thresh, else -inf.
    A row that is -inf everywhere gives (-inf, 0)."""
    c = cols.shape[0]
    cid = torch.arange(c, device=rows.device)
    best, idx = [], []
    for r0 in range(0, rows.shape[0], row_block):
        sim = rows[r0:r0 + row_block] @ cols.T
        scored = torch.where(2.0 - 2.0 * sim < thresh,
                             gain * sim + bias[None, :],
                             torch.tensor(float("-inf"), device=rows.device))
        val = scored.max(dim=1).values
        hit = (scored == val[:, None]) & (val[:, None] > float("-inf"))
        first = torch.where(hit, cid[None, :], c).min(dim=1).values
        best.append(val)
        idx.append(torch.where(first < c, first, 0))
    return torch.cat(best), torch.cat(idx).to(torch.int32)


def colmax(rows, cols, bias, thresh: float, gain: float):
    """NMS column-max (K3, `colmax_pallas`): rows (R, E), cols (C, E),
    bias (C,); thresh and gain host floats. Returns (best (R,) float32,
    idx (R,) int32)."""
    if rows.device.type == "cpu":
        return colmax_plain(rows, cols, bias, thresh, gain)
    for name, t in (("rows", rows), ("cols", cols), ("bias", bias)):
        _build.require_cuda_f32(f"colmax {name}", t)
    if (rows.dim() != 2 or cols.dim() != 2 or bias.shape != cols.shape[:1]
            or rows.shape[1] != cols.shape[1]):
        raise ValueError("colmax: rows (R, E), cols (C, E), bias (C,)")
    r, c = rows.shape[0], cols.shape[0]
    rp, cp = _build.pad_width(rows), _build.pad_width(cols)
    best = torch.empty((r,), dtype=torch.float32, device=rows.device)
    idx = torch.empty((r,), dtype=torch.int32, device=rows.device)
    err = _build.lib().sednet_colmax(
        rp.data_ptr(), cp.data_ptr(), bias.data_ptr(), r, c, rp.shape[1],
        float(thresh), float(gain), best.data_ptr(), idx.data_ptr(),
        _build.stream_of(rows))
    _build.check(err, "colmax")
    colmax.launches += 1
    return best, idx


colmax.launches = 0


def segsum_sorted_scan_plain(vals_t, dest, ends):
    """Plain PyTorch version of K5, the segmented inclusive scan of
    `sednet_tpu/cluster/spectral.py:_segment_sum_sorted_scan`: ceil(log2 E)
    passes in which entry e adds entry e - s when both have the same
    destination (s = 1, 2, 4, ...), so every partial is a plain pairwise
    add; the last entry of each segment then holds its sum, read at
    ends - 1. Empty destinations give exactly 0.

    vals_t (m, E) float32; dest (E,) ascending; ends (N,) cumulative
    counts. Returns (N, m)."""
    e = vals_t.shape[1]
    vals = vals_t.clone()
    s = 1
    while s < e:
        same = (dest[s:] == dest[:-s])[None, :]
        vals[:, s:] = vals[:, s:] + torch.where(same, vals[:, :-s], 0.0)
        s *= 2
    ends = ends.long()
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    last = vals[:, torch.clamp(ends - 1, 0, max(e - 1, 0))]
    return torch.where((ends > starts)[None, :], last, 0.0).T


def segsum_sorted_scan(vals_t, dest, ends):
    """K5 (`segsum_sorted_scan_pallas`): for each destination d the sum of
    the columns [ends[d-1], ends[d]) of vals_t (m, E), entries sorted by
    destination `dest` (E,); ends (N,) the cumulative counts
    (`cluster.spectral._sorted_transpose_layout`). Returns (N, m) float32,
    0 for empty destinations. On CUDA, vals_t must be contiguous float32
    and ends int32; the kernel reads the segment bounds from ends alone and
    is deterministic (no float atomics). It splits E into equal chunks and
    keeps the pieces of the segments that cross a chunk's edges in a
    scratch of 2 * chunks * m floats and chunks ints (a few hundred KB at
    E = 1.6M), added in chunk order by a second launch."""
    if vals_t.device.type == "cpu":
        return segsum_sorted_scan_plain(vals_t, dest, ends)
    _build.require_cuda_f32("segsum_sorted_scan vals_t", vals_t)
    if vals_t.dim() != 2 or dest.shape != vals_t.shape[1:]:
        raise ValueError("segsum_sorted_scan: vals_t (m, E), dest (E,)")
    if (ends.dim() != 1 or ends.dtype != torch.int32
            or ends.device != vals_t.device or not ends.is_contiguous()):
        raise ValueError("segsum_sorted_scan: ends must be a contiguous "
                         "(N,) int32 tensor on vals_t's device")
    m, e = vals_t.shape
    n = ends.shape[0]
    dev = vals_t.device
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    chunks = _build.lib().sednet_segsum_chunks(e)
    pieces = torch.empty((2 * chunks * m,), dtype=torch.float32, device=dev)
    cross = torch.empty((chunks,), dtype=torch.int32, device=dev)
    err = _build.lib().sednet_segsum_sorted(
        vals_t.data_ptr(), ends.data_ptr(), m, e, n, out.data_ptr(),
        pieces.data_ptr(), cross.data_ptr(), _build.stream_of(vals_t))
    _build.check(err, "segsum_sorted_scan")
    segsum_sorted_scan.launches += 1
    return out


segsum_sorted_scan.launches = 0
