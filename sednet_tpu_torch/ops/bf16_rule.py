"""The float64 rule that holds the bf16 mean-shift step (K2/K2b's
`bf16=True` branch) to float32 accuracy.

The bf16 step rounds every weight k = exp((s - 1) / b^2) to bf16 before
k @ x. The function it computes is that step in float64 on the bf16-rounded
inputs (`mean_shift_step_plain(..., bf16=True)` on float64), whose weights
round in float64. A weight that lies within float32's error of a bf16
rounding midpoint may round to either neighbour in any float32 evaluation,
the plain version's included: which one is decided by the order of the
sums, not by their accuracy. Such a weight moves its row by a whole bf16
step of k, far more than float32's error, so a rule that compares each
element with a multiple of the plain version's error alone is decided by
those few weights.

`check_bf16_step` holds them apart:

  * a weight is held apart when k (1 - d) and k (1 + d) round to different
    bf16 values, d the relative error a float32 evaluation may make in k
    under the same factor as the elements: twice the float32 plain
    version's measured error in this weight's s = x_i . x_c (its own
    product of the row block, against float64), times 1 / b^2, plus the
    rounding of the scaled argument (at most 75 in size) and expf's. A
    self-weight (c = i, s = |x_i|^2) takes the larger of that error and
    `SELF_TYPICAL` times the typical error of a float32 sum of its E
    squares, sqrt(E) u |x_i|^2: bf16 squares carry 16 significant bits,
    so the plain version often sums them exactly and its measured error
    there says nothing of another order's. `TYPICAL` gives every weight
    the same floor in the same units (0 by default: the measured error
    alone); and
    when rounding it the other way moves its row by more than a thousandth
    of the bound below (the others cannot decide anything). A kernel
    whose sums lose float32 accuracy moves its weights farther than that
    and is not covered;
  * every row within `factor` times the plain version's largest float64
    error (at least `floor`) passes as it is;
  * a row above it passes only if its held-apart weights, each rounded to
    one of its two bf16 neighbours of the float64 value, explain it: the
    neighbours are chosen greedily, one weight at a time, the one that
    lowers the row's largest error most, and the row must then be within
    the same bound. A row whose held-apart weights cannot bring it there,
    or that has none, fails.

The smoke (`chip_smoke.check_k2_bf16`), the card tests and
`scripts/probe_ms_bf16_accum.py` all call this one function.
"""
from __future__ import annotations

import torch

# float32's unit roundoff
_U32 = 2.0 ** -24


def bf16_neighbours(k):
    """(the bf16 rounding of k, the bf16 neighbour across k's nearer
    midpoint), both float64; k > 0 (float64)."""
    kb = k.to(torch.bfloat16)
    bits = kb.view(torch.int16)
    up = (bits + 1).view(torch.bfloat16).double()
    dn = (bits - 1).view(torch.bfloat16).double()
    kb = kb.double()
    return kb, torch.where(k >= kb, up, dn)


def _rows(xb, ib2, r0, r1):
    """Float64 weights of rows [r0, r1) of one shape: (s, k, kb, other,
    den, num) with xb the bf16-rounded rows as float64."""
    s = xb[r0:r1] @ xb.T
    k = torch.exp(torch.clamp_min((s - 1.0) * ib2, -75.0))
    kb, other = bf16_neighbours(k)
    den = torch.clamp_min(k.sum(1, keepdim=True), 1e-30)
    return s, k, kb, other, den, kb @ xb


# The floors of a weight's float32 error in s, in units of the typical
# error of a float32 sum of E products, sqrt(E) u sum_e |x_ie x_ce|: for
# every weight (`TYPICAL`) and for a self-weight (`SELF_TYPICAL`, the
# typical error itself).
TYPICAL = 0.0
SELF_TYPICAL = 1.0


def _units(rows, n, r0, device):
    """The floor of each weight of rows [r0, r0 + rows) against n columns,
    in units of the typical error: `TYPICAL`, and at least `SELF_TYPICAL`
    on the self-weights."""
    u = torch.full((rows, n), TYPICAL, dtype=torch.float64, device=device)
    at = torch.arange(rows, device=device)
    u[at, r0 + at] = max(TYPICAL, SELF_TYPICAL)
    return u


def _slack(inv_b2, s32, s64, mag, e, factor, units):
    """d, per weight: the relative error a float32 evaluation may make in
    it, `factor` times the larger of the float32 plain version's measured
    error in its s (the product s32 against s64) and `units` times the
    typical error of a float32 sum of its e products of magnitude sum mag,
    times 1 / b^2; plus the rounding of the scaled argument (at most 75
    in size) and expf's."""
    typical = units * e ** 0.5 * _U32 * mag
    return (factor * inv_b2 * torch.maximum((s32 - s64).abs(), typical)
            + 75.0 * _U32 + 2.0 ** -21)


def _ambiguous(k, d):
    return (k * (1 - d)).to(torch.bfloat16) != (k * (1 + d)).to(torch.bfloat16)


@torch.no_grad()
def weight_held_apart(x, inv_b2, bi: int, i: int, c: int,
                      factor: float = 2.0, row_block: int = 2048) -> bool:
    """Whether the weight of row i and column c of shape bi lies within
    its slack (`_slack`) of a bf16 rounding midpoint (the first condition
    of the rule; the second, that it can move its row, is the caller's)."""
    xb = x[bi].to(torch.bfloat16).double()
    r0 = i // row_block * row_block
    xf = xb.float()
    s32 = (xf[r0:r0 + row_block] @ xf.T)[i - r0, c].double()
    s64 = xb[i] @ xb[c]
    mag = xb[i].abs() @ xb[c].abs()
    k = torch.exp(torch.clamp_min((s64 - 1.0) * float(inv_b2[bi]), -75.0))
    units = max(TYPICAL, SELF_TYPICAL) if i == c else TYPICAL
    d = _slack(float(inv_b2[bi]), s32, s64, mag, xb.shape[-1], factor,
               units)
    return bool(_ambiguous(k.reshape(1), d))


def _normed(o):
    return o / torch.sqrt(torch.clamp_min((o * o).sum(-1, keepdim=True),
                                          1e-24))


def _fit_rows(got, num, den, moves, xb, cols, bound):
    """Greedy neighbour choice for rows that fail as they are: got (R, E)
    the kernel's rows, num (R, E) the float64 numerators, den (R, 1),
    moves (R, A) the change of each held-apart weight's rounding (0 where
    there is none), cols (R, A) its column. Returns (the rows' largest
    error after the choice (R,), the flips (R, A) bool, the numerators
    after them (R, E))."""
    cand = moves[..., None] * xb[cols]                      # (R, A, E)
    flips = torch.zeros(moves.shape, dtype=torch.bool, device=got.device)
    cur = num.clone()
    err = (got - _normed(cur / den)).abs().amax(-1)
    live = moves != 0
    for _ in range(moves.shape[1]):
        trial = (got[:, None] - _normed((cur[:, None] + cand) / den[:, None])
                 ).abs().amax(-1)
        trial = torch.where(live & ~flips, trial, torch.inf)
        best, j = trial.min(1)
        take = best < err
        if not bool(take.any()):
            break
        rows = take.nonzero()[:, 0]
        cur[rows] += cand[rows, j[rows]]
        flips[rows, j[rows]] = True
        err = torch.where(take, best, err)
    return err, flips, cur


def _diagnose(got, cur, den, move, xb, held, bi, i, err, bound):
    """A failed row i: the one weight c (of all its columns) whose
    rounding to its other bf16 neighbour, on top of the fit, would lower
    the row's error most; whether the rule held c apart, and the error
    before and after."""
    trial = (got[None] - _normed((cur[None] + move[:, None] * xb)
                                 / den)).abs().amax(-1)
    c = int(trial.argmin())
    return {"at": [bi, i], "column": c, "held_apart": bool(held[c]),
            "err": err, "err_with_it": float(trial[c]), "bound": bound}


@torch.no_grad()
def check_bf16_step(name, got, plain, x, inv_b2, *, factor: float = 2.0,
                    floor: float = 0.0, row_block: int = 2048,
                    max_named: int = 8, raise_on_fail: bool = True):
    """Hold a bf16 step's output `got` (B, N, E) to the float64 function
    on the bf16-rounded inputs x (B, N, E) float32 with inv_b2 (B,) = 1/b^2,
    by the rule of the module docstring; `plain` is the float32 plain
    version's output on the same inputs (`mean_shift_step_plain(x, x,
    inv_b2, bf16=True)`), whose largest float64 error sets the bound
    max(factor * it, floor).

    Returns {"f64_err": the kernel's largest error, "plain_f64_err",
    "bound", "held_apart": weights held apart, "held_named": up to
    max_named of the ones a failing row rounded the other way ([b, i, c]),
    "held_flipped": how many, "rows_fitted": rows that passed only so,
    "f64_err_outside": the largest row error after the choice,
    "rows_failed", "failed_named": up to max_named of those, each with the
    one weight whose other rounding would best explain what is left
    (`_diagnose`)}. Raises
    AssertionError when a row fails, unless raise_on_fail is False."""
    b, n, e = x.shape
    xb_all = x.to(torch.bfloat16).double()
    got = got[..., :e].double()
    plain = plain[..., :e].double()
    inv = inv_b2.double()
    # pass 1: the exact function and the plain error
    exact = torch.empty_like(got)
    for bi in range(b):
        for r0 in range(0, n, row_block):
            _, _, _, _, den, num = _rows(xb_all[bi], inv[bi], r0,
                                         r0 + row_block)
            exact[bi, r0:r0 + row_block] = _normed(num / den)
    plain_err = float((plain - exact).abs().max())
    bound = max(factor * plain_err, floor)
    row_err = (got - exact).abs().amax(-1)                   # (B, N)
    out = {"f64_err": float(row_err.max()), "plain_f64_err": plain_err,
           "bound": bound, "held_apart": 0, "held_named": [],
           "held_flipped": 0, "rows_fitted": 0, "f64_err_outside": 0.0,
           "rows_failed": 0, "failed_named": []}
    # pass 2: the held-apart weights, and the fit of the rows above bound
    for bi in range(b):
        xb = xb_all[bi]
        xf = xb.float()
        for r0 in range(0, n, row_block):
            s, k, kb, other, den, num = _rows(xb, inv[bi], r0, r0 + row_block)
            # the plain version's own float32 product of this row block
            s32 = (xf[r0:r0 + row_block] @ xf.T).double()
            mag = xb[r0:r0 + row_block].abs() @ xb.abs().T
            amb = _ambiguous(k, _slack(float(inv[bi]), s32, s, mag, e,
                                       factor, _units(s.shape[0], n, r0,
                                                      s.device)))
            del s32, mag
            nrm = torch.sqrt((num * num).sum(-1, keepdim=True)) / den
            move = (other - kb)
            # how far rounding the other way moves the row, at most
            reach = (move.abs() * xb.abs().amax(-1)[None]) / den / nrm
            held = amb & (reach > 1e-3 * bound)
            out["held_apart"] += int(held.sum())
            err = row_err[bi, r0:r0 + row_block]
            over = (err > bound).nonzero()[:, 0]
            if over.numel():
                h = held[over]
                a = max(int(h.sum(1).max()), 1)
                mv = torch.where(h, move[over], 0.0)
                cols = mv.abs().topk(a, 1).indices
                mv = torch.gather(mv, 1, cols)
                fit, flips, cur = _fit_rows(got[bi, r0 + over], num[over],
                                            den[over], mv, xb, cols, bound)
                ok = fit <= bound
                out["rows_fitted"] += int(ok.sum())
                out["held_flipped"] += int(flips[ok].sum())
                for ri, ci in flips[ok].nonzero().tolist():
                    if len(out["held_named"]) < max_named:
                        out["held_named"].append(
                            [bi, r0 + int(over[ok][ri]),
                             int(cols[ok][ri, ci])])
                for ri in (~ok).nonzero()[:, 0].tolist():
                    if len(out["failed_named"]) < max_named:
                        r = int(over[ri])
                        out["failed_named"].append(_diagnose(
                            got[bi, r0 + r], cur[ri], den[r], move[r], xb,
                            held[r], bi, r0 + r, float(fit[ri]), bound))
                out["rows_failed"] += int((~ok).sum())
                err = err.clone()
                err[over] = fit
            out["f64_err_outside"] = max(out["f64_err_outside"],
                                         float(err.max()))
    if raise_on_fail and out["rows_failed"]:
        raise AssertionError(f"{name}: {out['rows_failed']} rows above the "
                             f"float64 bound that no held-apart weight "
                             f"explains: {out}")
    return out
