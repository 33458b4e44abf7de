"""Mean-shift step (kernels K2/K2b) and NMS column-max (kernel K3).

Counterparts of `sednet_tpu/ops/pallas_kernels.py`:

  * `mean_shift_step` / `mean_shift_step_batched` -- `mean_shift_step_pallas`
    and `mean_shift_step_pallas_batched`. One CUDA kernel with a batch grid
    axis (`csrc/mean_shift.cu`) serves both; each wrapper counts its own
    launches.
  * `colmax` -- `colmax_pallas` (`csrc/colmax.cu`).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
beside it. The kernels hold rows of width 128; narrower rows are padded with
zero columns, which change neither a dot product nor a norm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sednet_tpu_torch.ops import _build

WIDTH = 128


def _pad_width(t):
    e = t.shape[-1]
    if e > WIDTH:
        raise ValueError(f"row width {e} exceeds the kernels' {WIDTH}")
    return t if e == WIDTH else F.pad(t, (0, WIDTH - e)).contiguous()


def mean_shift_step_plain(new_x, x, inv_b2, row_block: int = 2048):
    """Plain PyTorch version: new_x, x (B, N, E); inv_b2 (B,) = 1/b^2.

        k = exp(max((new_x . x - 1) * inv_b2, -75))
        out = rownorm((k @ x) / max(k.1, 1e-30)),  norm eps 1e-24
    """
    out = torch.empty_like(new_x)
    for b in range(x.shape[0]):
        for r0 in range(0, x.shape[1], row_block):
            s = new_x[b, r0:r0 + row_block] @ x[b].T
            k = torch.exp(torch.clamp_min((s - 1.0) * inv_b2[b], -75.0))
            o = (k @ x[b]) / torch.clamp_min(k.sum(1, keepdim=True), 1e-30)
            nrm = torch.sqrt(torch.clamp_min((o * o).sum(1, keepdim=True),
                                             1e-24))
            out[b, r0:r0 + row_block] = o / nrm
    return out


def _ms_launch(new_x, x, inv_b2):
    _build.require_cuda_f32("mean_shift_step new_x", new_x)
    _build.require_cuda_f32("mean_shift_step x", x)
    if new_x.shape != x.shape or x.dim() != 3:
        raise ValueError("mean_shift_step: new_x and x must both be (B, N, E)")
    e = x.shape[-1]
    q, xp = _pad_width(new_x), _pad_width(x)
    inv_b2 = inv_b2.to(device=x.device, dtype=torch.float32).reshape(-1)
    inv_b2 = inv_b2.contiguous()
    if inv_b2.shape[0] != x.shape[0]:
        raise ValueError("mean_shift_step: one bandwidth per shape")
    out = torch.empty_like(q)
    err = _build.lib().sednet_mean_shift_step(
        q.data_ptr(), xp.data_ptr(), inv_b2.data_ptr(), x.shape[0],
        x.shape[1], out.data_ptr(), _build.stream_of(x))
    _build.check(err, "mean_shift_step")
    return out if e == WIDTH else out[..., :e]


def _inv_b2(bandwidth, like):
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=like.device)
    return 1.0 / (bw * bw)


def mean_shift_step(new_x, x, bandwidth):
    """One mean-shift update of one shape: new_x, x (N, E) unit rows,
    bandwidth a scalar (K2, `mean_shift_step_pallas`)."""
    inv_b2 = _inv_b2(bandwidth, x).reshape(1)
    if x.device.type == "cpu":
        return mean_shift_step_plain(new_x[None], x[None], inv_b2)[0]
    out = _ms_launch(new_x[None], x[None], inv_b2)[0]
    mean_shift_step.launches += 1
    return out


def mean_shift_step_batched(new_x, x, bandwidth):
    """Batched update: new_x, x (B, N, E), bandwidth (B,) (K2b,
    `mean_shift_step_pallas_batched`)."""
    inv_b2 = _inv_b2(bandwidth, x).reshape(-1)
    if x.device.type == "cpu":
        return mean_shift_step_plain(new_x, x, inv_b2)
    out = _ms_launch(new_x, x, inv_b2)
    mean_shift_step_batched.launches += 1
    return out


mean_shift_step.launches = 0
mean_shift_step_batched.launches = 0


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
    if rows.dim() != 2 or cols.dim() != 2 or bias.shape != cols.shape[:1]:
        raise ValueError("colmax: rows (R, E), cols (C, E), bias (C,)")
    r, c = rows.shape[0], cols.shape[0]
    rp, cp = _pad_width(rows), _pad_width(cols)
    best = torch.empty((r,), dtype=torch.float32, device=rows.device)
    idx = torch.empty((r,), dtype=torch.int32, device=rows.device)
    err = _build.lib().sednet_colmax(
        rp.data_ptr(), cp.data_ptr(), bias.data_ptr(), r, c, float(thresh),
        float(gain), best.data_ptr(), idx.data_ptr(), _build.stream_of(rows))
    _build.check(err, "colmax")
    colmax.launches += 1
    return best, idx


colmax.launches = 0
