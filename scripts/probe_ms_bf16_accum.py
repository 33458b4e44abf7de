"""How K2/K2b's bf16 kernel should sum S = Q.X^T, on one NVIDIA GPU.

    python3 scripts/probe_ms_bf16_accum.py [--out FILE]

The kernel (`csrc/mean_shift_bf16.cu`) sums S's k-steps in two partials,
each over half of them in a fresh wgmma accumulator, added in float32
(`Consumer::issue_s`, `sum_s`). This probe builds beside it, from its
source with S's accumulation rewritten (`FORMS`, into
build/ms_bf16_accum/): `chained`, every k-step in one accumulator;
`partsP`, P fresh partials of consecutive k-steps, as even as can be (at
144, KS = 9: parts2 5 + 4, the kernel's split, whose bits it must give;
parts3 3 + 3 + 3; parts4 3 + 2 + 2 + 2); `serial`, each k-step alone from
zero and added in float32 in order, which matches float32 sums of the
16-deep products. Each
form is built twice, as it is (timed) and with a hook that reads one
element's s and weight (`-DSEDNET_DBG`); only the widths 128 and 144.

On the inputs of the smoke's `ms_bf16` phase (the headline embeddings at
E = 128, one shape and the batch, and the eval's enriched embeddings, 140
run at 144, with their bandwidths, `chip_smoke.ms_bf16_inputs`), for each
form: the largest and mean float64 error (against the function in float64
on the bf16-rounded inputs, which rounds the weights to bf16 too), the
smoke's rule on it (`ops.bf16_rule.check_bf16_step`: passed, the weights
held apart, and for a failure whether its decisive weight was one of
them), the plain bf16 version's error, their ratio, the
device ms of a launch (20 between CUDA events), and the element that
decides the largest error: its row, and the one weight whose bf16 rounding
to the other neighbour explains most of that row's error vector (the
fraction explained). For every such weight: s and the weight in float64,
in the plain version (its own float32 product of the row block) and in
every form (the hook), with the bf16 midpoint between the weight's two
neighbours, each weight's signed distance from it in bf16 steps, and the
move of s that reaches it. Then the same rule on the same embeddings
with every bandwidth scaled (`SCALES`), a fresh draw of the weights near
a midpoint: each form's ratio a draw. Prints one JSON line a record, the
card's name and power limit first (about 2 min with the builds).

    python3 scripts/probe_ms_bf16_accum.py --floors 0:1,0:0,0.2:0.2 [--out F]

evaluates the rule at each pair of its typical-error floors instead
(`floor_sweep`; TYPICAL:SELF_TYPICAL, every weight's and a self-weight's):
the card tests' bf16 cases, and the kernel's and the chained form's 19
cases (about 3 min).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCALES = (0.85, 0.9, 0.95, 1.05, 1.1, 1.15, 1.2, 1.25)

# the kernel's S: from its first line to the comment before P.X
S_BLOCK = re.compile(r"  static constexpr int HALF = .*?(?=  // num \+= P\.X)",
                     re.S)
WEIGHT = "      float k = ex2(fmaxf((s[v] - 1.f) * c2, LO));\n"
CONSUMER = "template <int E>\nstruct Consumer {"
END = "}  // namespace\n"
DISPATCH = re.compile(r"    case (\d+): return launch<\d+>\(.*\n")

MEMBERS = """  Acc<G::NMAIN> nm;
  Acc<G::NTAIL> nt;
  float s[CB / 2];
  uint32_t p[CB / 16][4];
  float den[2];
"""
OFFSETS = """      const uint32_t qo = ((kk / 4) * ROWS * 128 + (kk % 4) * 32) >> 4;
      const uint32_t xo = ((kk / 4) * CB * 128 + (kk % 4) * 32) >> 4;
"""


def partials(np_):
    """S in np_ fresh partials of consecutive k-steps, as even as can be
    (the first ones longer), added in order."""
    return f"""  static constexpr int NP = {np_};
  // the first k-step of partial j, and the partial of k-step kk
  __host__ __device__ static constexpr int start(int j) {{
    return (j * KS + NP - 1) / NP;
  }}
  __host__ __device__ static constexpr int part(int kk) {{
    int j = 0;
    while (j + 1 < NP && start(j + 1) <= kk) ++j;
    return j;
  }}
{MEMBERS}  float sp[NP > 1 ? NP - 1 : 1][CB / 2];

  __device__ __forceinline__ void issue_s(uint64_t q, uint64_t x) {{
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {{
{OFFSETS}      const int pi = part(kk);
      if (pi == 0)
        wgmma::SS<CB>::mma(s, q + qo, x + xo, kk > 0);
      else
        wgmma::SS<CB>::mma(sp[pi - 1], q + qo, x + xo, kk > start(pi));
    }}
  }}

  __device__ __forceinline__ void fence_s() {{
    wgmma::fence_operands(s);
#pragma unroll
    for (int j = 0; j < NP - 1; ++j) wgmma::fence_operands(sp[j]);
  }}

  __device__ __forceinline__ void sum_s() {{
#pragma unroll
    for (int j = 0; j < NP - 1; ++j)
#pragma unroll
      for (int v = 0; v < CB / 2; ++v) s[v] += sp[j][v];
  }}

"""


SERIAL = f"""{MEMBERS}  float s2[CB / 2];

  // each k-step from zero, waited for and added in float32 in order
  __device__ __forceinline__ void issue_s(uint64_t q, uint64_t x) {{
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {{
{OFFSETS}      wgmma::fence();
      if (kk == 0)
        wgmma::SS<CB>::mma(s, q + qo, x + xo, 0);
      else
        wgmma::SS<CB>::mma(s2, q + qo, x + xo, 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operands(s);
      wgmma::fence_operands(s2);
      if (kk > 0) {{
#pragma unroll
        for (int v = 0; v < CB / 2; ++v) s[v] += s2[v];
      }}
    }}
  }}

  __device__ __forceinline__ void fence_s() {{
    wgmma::fence_operands(s);
    wgmma::fence_operands(s2);
  }}

  __device__ __forceinline__ void sum_s() {{}}

"""

FORMS = {"two_partials": None, "chained": partials(1), "parts2": partials(2),
         "parts3": partials(3), "parts4": partials(4), "serial": SERIAL}

HOOK = """#ifdef SEDNET_DBG
__device__ int g_dbg_at[3] = {-1, -1, -1};
__device__ float g_dbg_val[2];
// s and the weight of (shape, row, column) g_dbg_at, into g_dbg_val
__device__ __forceinline__ void dbg_hook(int col, int dr, float s, float k) {
  const int split = (int)cg::this_cluster().num_blocks();
  const int row = (int)(blockIdx.x / split) * ROWS +
                  ((int)threadIdx.x / 128 - 1) * 64 +
                  (((int)threadIdx.x / 32) & 3) * 16 +
                  (((int)threadIdx.x & 31) >> 2) + dr;
  if ((int)blockIdx.y == g_dbg_at[0] && row == g_dbg_at[1] &&
      col == g_dbg_at[2]) {
    g_dbg_val[0] = s;
    g_dbg_val[1] = k;
  }
}
#endif

"""
HOOK_CALL = """#ifdef SEDNET_DBG
      dbg_hook(c0 + 8 * (v / 4) + 2 * t + (v & 1), 8 * ((v >> 1) & 1), s[v],
               k);
#endif
"""
HOOK_HOST = """
#ifdef SEDNET_DBG
extern "C" int sednet_dbg_at(int b, int row, int col) {
  const int at[3] = {b, row, col};
  return (int)cudaMemcpyToSymbol(g_dbg_at, at, sizeof(at));
}
extern "C" int sednet_dbg_read(float* out) {
  return (int)cudaMemcpyFromSymbol(out, g_dbg_val, sizeof(float) * 2);
}
#endif
"""


def form_source(src, block):
    """The kernel's source with S's accumulation `block` (None: as it is),
    the hook, and only the widths 128 and 144."""
    for part in (S_BLOCK.search(src), WEIGHT in src, CONSUMER in src,
                 END in src):
        if not part:
            raise RuntimeError("mean_shift_bf16.cu no longer has the shape "
                               "this probe rewrites")
    if block is not None:
        src = S_BLOCK.sub(lambda _: block, src, count=1)
    src = src.replace(WEIGHT, WEIGHT + HOOK_CALL)
    src = src.replace(CONSUMER, HOOK + CONSUMER, 1)
    src = src.replace(END, END + HOOK_HOST, 1)
    return DISPATCH.sub(lambda m: m.group(0) if m.group(1) in ("128", "144")
                        else "", src)


def build_forms():
    """Every form built alone into build/ms_bf16_accum/, with and without
    the hook; returns ({form: launch}, {form: (launch, at, read)},
    {form: ptxas spill lines})."""
    from sednet_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "mean_shift_bf16.cu")).read()
    out_dir = os.path.join(ROOT, "build", "ms_bf16_accum")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for form, block in FORMS.items():
        path = os.path.join(out_dir, f"{form}.cu")
        with open(path, "w") as f:
            f.write(form_source(src, block))
        for dbg in (False, True):
            so = os.path.join(out_dir, f"{form}{'_dbg' if dbg else ''}.so")
            procs[form, dbg] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 *(["-DSEDNET_DBG"] if dbg else []), "-shared", path, "-o",
                 so], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns, dbgs, spills = {}, {}, {}
    for (form, dbg), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {form} (hook {dbg}):\n{log}")
        lib = ctypes.CDLL(so)
        fn = lib.sednet_mean_shift_step_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        if dbg:
            lib.sednet_dbg_at.argtypes = [ctypes.c_int] * 3
            lib.sednet_dbg_read.argtypes = [ctypes.c_void_p]
            dbgs[form] = (fn, lib.sednet_dbg_at, lib.sednet_dbg_read)
        else:
            fns[form] = fn
            spills[form] = sorted(set(re.findall(
                r"\d+ bytes stack frame, \d+ bytes spill stores, "
                r"\d+ bytes spill loads", log)))
    return fns, dbgs, spills


def bf16_neighbours(k):
    """(the bf16 rounding of k, the bf16 neighbour across k's nearer
    midpoint), as float64; k > 0."""
    import torch

    kb = k.to(torch.bfloat16)
    bits = kb.view(torch.int16)
    up = (bits + 1).view(torch.bfloat16).double()
    dn = (bits - 1).view(torch.bfloat16).double()
    kb = kb.double()
    return kb, torch.where(k >= kb, up, dn)


def decisive(out, exact, xe, inv_b2):
    """The element of out's largest float64 error, and the one weight of
    its row whose rounding to the other bf16 neighbour best explains the
    row's error vector."""
    import torch

    b, n, e = xe.shape
    err = (out[..., :e].double() - exact).abs()
    flat = int(err.argmax())
    bi, i, d = flat // (n * e), flat // e % n, flat % e
    xb = xe[bi].to(torch.bfloat16).double()
    ib2 = float(inv_b2[bi])
    s = xb @ xb[i]
    k = torch.exp(torch.clamp_min((s - 1.0) * ib2, -75.0))
    kb, other = bf16_neighbours(k)
    den = k.sum()
    num = kb @ xb
    o = (num[None] + (other - kb)[:, None] * xb) / den
    o = o / o.norm(dim=1, keepdim=True)
    vec = out[bi, i, :e].double() - exact[bi, i]
    res = (o - exact[bi, i][None] - vec[None]).norm(dim=1)
    c = int(res.argmin())
    return {"at": [bi, i, d], "err": float(err[bi, i, d]), "column": c,
            "explained": 1.0 - float(res[c] / vec.norm()),
            "weight_over_den": float(k[c] / den)}


def weight_record(xe, inv_b2, bi, i, c, dbgs, launch_dbg, row_block=2048):
    """s and the weight of (bi, i, c): in float64, in the plain version and
    in every form, against the bf16 midpoint."""
    import math

    import torch

    xb = xe[bi].to(torch.bfloat16)
    s64 = float(xb[i].double() @ xb[c].double())
    ib2 = float(inv_b2[bi])
    k64 = math.exp(max((s64 - 1.0) * ib2, -75.0))
    kb, other = (float(t) for t in bf16_neighbours(
        torch.tensor([k64], dtype=torch.float64)))
    mid, step = 0.5 * (kb + other), abs(other - kb)

    def side(s, k):
        return {"s": s, "s_minus_f64": s - s64, "k": k,
                "from_midpoint_steps": (k - mid) / step,
                "bf16": float(torch.tensor([k]).to(torch.bfloat16).double()),
                "rounds_as_f64": float(torch.tensor([k]).to(torch.bfloat16)
                                       .double()) == kb}

    # the plain version's own product: its row block against every column
    xf = xe[bi].to(torch.bfloat16).float()
    r0 = i // row_block * row_block
    sp = (xf[r0:r0 + row_block] @ xf.T)[i - r0, c]
    kp = torch.exp(torch.clamp_min((sp - 1.0) * inv_b2[bi], -75.0))
    rec = {"at": [bi, i, c], "inv_b2": ib2, "s_f64": s64, "k_f64": k64,
           "k_bf16": kb, "other_bf16": other, "midpoint": mid,
           "f64_from_midpoint_steps": (k64 - mid) / step,
           "s_move_to_midpoint": math.log(mid / k64) / ib2,
           "plain": side(float(sp), float(kp))}
    for form, (fn, at, read) in dbgs.items():
        if at(bi, i, c):
            raise RuntimeError("sednet_dbg_at failed")
        launch_dbg(fn)
        torch.cuda.synchronize()
        v = (ctypes.c_float * 2)()
        if read(ctypes.addressof(v)):
            raise RuntimeError("sednet_dbg_read failed")
        rec[form] = side(float(v[0]), float(v[1]))
    return rec


def rule_record(out, plain, xe, inv_b2, exact):
    """The shared float64 rule (`ops.bf16_rule.check_bf16_step`) on one
    form's output: passed or not, the weights it held apart, the rows it
    passed only by rounding one of them the other way, and for a failure
    the weight that best explains the worst row (`decisive`) and whether
    the rule held that weight apart, and whether the weight that best
    explains what a failed row keeps after the rule's choice
    (`failed_named`) is one the rule does not hold apart."""
    from sednet_tpu_torch.ops.bf16_rule import (check_bf16_step,
                                                weight_held_apart)

    r = check_bf16_step("probe", out, plain, xe, inv_b2,
                        raise_on_fail=False)
    rec = {"passed": r["rows_failed"] == 0,
           **{k: r[k] for k in ("held_apart", "held_flipped", "rows_fitted",
                                "rows_failed", "failed_named",
                                "f64_err_outside", "bound")}}
    if r["rows_failed"]:
        dec = decisive(out, exact, xe, inv_b2)
        bi, i = dec["at"][:2]
        dec["held_apart"] = weight_held_apart(xe, inv_b2, bi, i,
                                              dec["column"])
        rec["decisive"] = dec
        rec["not_held_apart"] = any(not f["held_apart"]
                                    for f in r["failed_named"])
    return rec


def floor_sweep(floors, fns, emb, bw, emb_e, bw_e, emit):
    """The rule under each pair of floors (`ops.bf16_rule.TYPICAL`,
    `SELF_TYPICAL`), written "all:self": every bf16
    parametrisation of the card test `_bf16_kernel_against_float64`
    (failures listed), then the kernel's and the chained form's outputs on
    the 19 cases (`rule_record`: passed, and for a failure whether the
    weight that best explains it is one the rule does not hold apart)."""
    import torch

    from sednet_tpu_torch.ops import bf16_rule
    from sednet_tpu_torch.ops import cuda_kernels as ck

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_port_cuda as tc

    cuda = torch.device("cuda")
    params = ([(n, e, b) for b in (1, 3)
               for e in (12, 32, 40, 64, 112, 140, 200, 240, 256)
               for n in (1, 63, 3001)] + [(10000, 128, 2)])
    default = bf16_rule.TYPICAL, bf16_rule.SELF_TYPICAL

    def use(c):
        bf16_rule.TYPICAL, bf16_rule.SELF_TYPICAL = (
            float(v) for v in c.split(":"))

    try:
        for c in floors:
            use(c)
            fails = []
            for n, e, b in params:
                try:
                    tc._bf16_kernel_against_float64(cuda, n, e, b)
                except AssertionError as exc:
                    msg = str(exc)
                    # the case, and the weights that best explain each
                    # failed row (`failed_named`: column, held apart)
                    fails.append([n, e, b, msg[:120],
                                  msg[msg.find("'failed_named'"):][:900]])
            emit({"floor": c, "card_cases": len(params),
                  "card_cases_failed": fails})
        for case, xe, bws in (("K2 bf16, one shape E=128", emb[:1], bw[:1]),
                              ("K2b bf16 E=128", emb, bw),
                              ("K2b bf16, enriched E=140", emb_e, bw_e)):
            b, n, e = xe.shape
            xk = ck.kernel_width(xe, bf16=True).to(torch.bfloat16)
            out = torch.empty(xk.shape, device="cuda")
            for scale in (1.0,) + (SCALES if b > 1 else ()):
                inv_b2 = (1.0 / (bws * bws * scale * scale)).float(
                ).contiguous()
                plain = ck.mean_shift_step_plain(xe, xe, inv_b2, bf16=True)
                exact = ck.mean_shift_step_plain(
                    xe.double(), xe.double(), inv_b2.double(), bf16=True)
                rec = {"case": case, "bandwidth_scale": scale}
                for form in ("two_partials", "chained"):
                    if fns[form](xk.data_ptr(), xk.data_ptr(),
                                 inv_b2.data_ptr(), b, n, xk.shape[-1],
                                 out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream):
                        raise RuntimeError(f"{case}: {form} failed")
                    rec[form] = {}
                    for c in floors:
                        use(c)
                        r = rule_record(out, plain, xe, inv_b2, exact)
                        rec[form][c] = {
                            k: r.get(k) for k in ("passed", "held_apart",
                                                  "rows_fitted",
                                                  "rows_failed",
                                                  "not_held_apart",
                                                  "failed_named")}
                emit(rec)
    finally:
        bf16_rule.TYPICAL, bf16_rule.SELF_TYPICAL = default


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--floors", default=None,
                    help="comma-separated pairs TYPICAL:SELF_TYPICAL of the "
                         "rule's floors (ops.bf16_rule): the card tests' bf16 "
                         "cases and the kernel's and the chained form's 19 "
                         "cases under each, instead of the forms' records")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.predict import forward, headline_shapes, load_models

    if not torch.cuda.is_available():
        sys.exit("probe_ms_bf16_accum: no CUDA device")
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"card": cs.nvidia_smi()})
    fns, dbgs, spills = build_forms()
    emit({"spills": spills})
    _, x_np = headline_shapes(cs.BATCH, cs.N_POINTS)
    models = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                         device="cuda")
    x = torch.from_numpy(x_np).to("cuda")
    with torch.no_grad():
        emb = forward(models["inst"], x)[0].contiguous()
        bw, emb_e, bw_e = cs.ms_bf16_inputs(models, x, emb)

    if args.floors:
        floor_sweep(args.floors.split(","), fns, emb,
                    bw, emb_e, bw_e, emit)
    for case, xe, bws in () if args.floors else (
            ("K2 bf16, one shape E=128", emb[:1], bw[:1]),
                          ("K2b bf16 E=128", emb, bw),
                          ("K2b bf16, enriched E=140", emb_e, bw_e)):
        b, n, e = xe.shape
        xk = ck.kernel_width(xe, bf16=True).to(torch.bfloat16)
        out = torch.empty(xk.shape, device="cuda")

        def launch(fn, inv_b2):
            err = fn(xk.data_ptr(), xk.data_ptr(), inv_b2.data_ptr(), b, n,
                     xk.shape[-1], out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{case}: CUDA error {err}")
            return out

        for scale in (1.0,) + (SCALES if b > 1 else ()):
            inv_b2 = (1.0 / (bws * bws * scale * scale)).float().contiguous()
            plain = ck.mean_shift_step_plain(xe, xe, inv_b2, bf16=True)
            exact = ck.mean_shift_step_plain(xe.double(), xe.double(),
                                             inv_b2.double(), bf16=True)
            plain_err = float((plain.double() - exact).abs().max())
            rec = {"case": case, "shape": [b, n, e],
                   "run_width": xk.shape[-1], "bandwidth_scale": scale,
                   "plain_f64_err": plain_err,
                   "plain_mean_err": float((plain.double() - exact).abs()
                                           .mean())}
            if scale == 1.0:
                rec["bandwidths"] = bws.tolist()
                rec["plain_decisive"] = decisive(plain, exact, xe, inv_b2)
            outs = {}
            for form, fn in fns.items():
                err = (launch(fn, inv_b2)[..., :e].double() - exact).abs()
                outs[form] = out.clone() if scale == 1.0 else None
                rec[form] = {"f64_err": float(err.max()),
                             "ratio": float(err.max()) / plain_err,
                             "mean_err": float(err.mean()),
                             "rule": rule_record(out, plain, xe, inv_b2,
                                                 exact)}
                if scale == 1.0:
                    rec[form]["kernel_ms"] = cs.burst_ms(
                        lambda: launch(fn, inv_b2))
                    rec[form]["decisive"] = decisive(outs[form], exact, xe,
                                                     inv_b2)
            if scale == 1.0:
                rec["parts2_bits_equal_kernel"] = bool(torch.equal(
                    outs["parts2"], outs["two_partials"]))
                seen = {tuple(rec["plain_decisive"]["at"][:2] + [
                    rec["plain_decisive"]["column"]])}
                seen |= {tuple(rec[f]["decisive"]["at"][:2]
                               + [rec[f]["decisive"]["column"]])
                         for f in fns}
                rec["weights"] = [weight_record(
                    xe, inv_b2, bi, i, c, dbgs,
                    lambda fn: launch(fn, inv_b2)) for bi, i, c in
                    sorted(seen)]
            emit(rec)
            del plain, exact, outs
        del out
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
