"""The spectral LOBPCG solve eagerly and replayed as CUDA graphs, on one
NVIDIA GPU.

    python3 scripts/bench_lobpcg_replay.py [--clouds 8] [--points 10000] [--reps 3] [--out FILE]

Builds the dense affinity of --clouds synthetic clouds of --points points
(`cluster.spectral.normal_affinity_topk`, as the eval does) and solves each
for k = 12 in at most 10 iterations from seeded start blocks, first
eagerly (the replay cache emptied before every solve), then replayed (the
key captured at its second solve, before the timing). For each mode: the
host ms of a synced solve (median, min, max over the clouds and --reps),
the iterations, and from one profiled pass over the clouds the CUDA
runtime calls (kernel and graph launches, copies) and the host reads
(`aten::_local_scalar_dense`) of a solve's set-up (a solve with m = 0)
and of an iteration, and the device's busy ms a solve. Holds every
replayed solve to the eager solve's bits, and reports whether
`torch.linalg.qr` captures on its own. Prints one JSON line, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def qr_captures(torch) -> bool:
    """Whether `torch.linalg.qr` of a (24, 12) block captures into a CUDA
    graph and replays to the eager bits."""
    m = torch.randn(24, 12, device="cuda")
    want = torch.linalg.qr(m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            torch.linalg.qr(m)
            g.capture_begin(capture_error_mode="thread_local")
            try:
                got = torch.linalg.qr(m)
            finally:
                g.capture_end()
    except RuntimeError as e:
        print(f"qr does not capture: {e}", file=sys.stderr)
        return False
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    return all(torch.equal(a, b) for a, b in zip(got, want))


def profiled_counts(torch, fn) -> dict:
    """fn() under torch.profiler: the CUDA runtime calls by name, the host
    reads, and the device's busy seconds (merged kernels, copies,
    memsets)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import Trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    calls = {}
    for e in events:
        if e.get("cat", "").startswith("cuda_"):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    reads = sum(1 for e in events if e.get("name") == "aten::_local_scalar_dense"
                and e.get("cat") == "cpu_op")
    return {"out": out, "calls": calls, "reads": reads,
            "busy_s": Trace(events, 0.0).busy_s}


def per(counts: dict, base: dict, n: float) -> dict:
    keys = set(counts) | set(base)
    return {k: round((counts.get(k, 0) - base.get(k, 0)) / n, 2)
            for k in sorted(keys) if counts.get(k, 0) != base.get(k, 0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clouds", type=int, default=8)
    ap.add_argument("--points", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    from sednet_tpu_torch.cluster import lobpcg
    from sednet_tpu_torch.cluster.spectral import normal_affinity_topk
    from sednet_tpu_torch.data import make_synthetic_shape

    if not torch.cuda.is_available():
        sys.exit("bench_lobpcg_replay: no CUDA device")
    rec = {"card": card(), "torch": torch.__version__,
           "clouds": args.clouds, "points": args.points,
           "qr_captures": qr_captures(torch)}
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    affs, x0s = [], []
    for _ in range(args.clouds):
        d = make_synthetic_shape(rng, n_points=args.points)
        xyz, nrm = (torch.from_numpy(d[k].astype(np.float32)).cuda()
                    for k in ("points", "normals"))
        affs.append(normal_affinity_topk(xyz, nrm))
        x0s.append(torch.randn((args.points, 12), generator=gen).cuda())

    def solve(i, m=10):
        return lobpcg.lobpcg_standard(affs[i], x0s[i], m=m)

    def timed(eager: bool):
        res, ms = [], []
        for _ in range(args.reps):
            for i in range(args.clouds):
                if eager:
                    lobpcg._REPLAYS.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = solve(i)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                res.append(out)
        return res[:args.clouds], ms

    def all_clouds(eager: bool):
        out = []
        for i in range(args.clouds):
            if eager:
                lobpcg._REPLAYS.clear()
            out.append(solve(i))
        return out

    for i in range(2):
        solve(i)                       # warm the eager path
    lobpcg._REPLAYS.clear()
    setup = profiled_counts(torch, lambda: solve(0, m=0))
    modes = {}
    for mode in ("eager", "replay"):
        eager = mode == "eager"
        if not eager:
            lobpcg._REPLAYS.clear()
            t0 = time.perf_counter()
            solve(0)
            solve(0)                   # the second solve of the key captures
            torch.cuda.synchronize()
            rec["capture_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["captured"] = len(lobpcg._REPLAYS.replays)
            rec["failed"] = [str(k) for k in lobpcg._REPLAYS.failed]
            if lobpcg._REPLAYS.replays:
                r = next(iter(lobpcg._REPLAYS.replays.values()))
                rec["graphs_an_iteration"] = len(r.graphs)
                rec["eighs_an_iteration"] = len(r.asks)
        res, ms = timed(eager)
        prof = profiled_counts(torch, lambda: all_clouds(eager))
        its = sum(int(o[2]) for o in prof["out"])
        modes[mode] = {
            "res": res,
            "solve_ms_median": statistics.median(ms),
            "solve_ms_min": min(ms), "solve_ms_max": max(ms),
            "iterations": [int(o[2]) for o in res],
            "busy_ms_a_solve": 1e3 * prof["busy_s"] / args.clouds,
            "calls_an_iteration": per(
                prof["calls"], {k: v * args.clouds
                                for k, v in setup["calls"].items()}, its),
            "reads_an_iteration": (prof["reads"]
                                   - setup["reads"] * args.clouds) / its}
    rec["setup_calls"] = setup["calls"]
    rec["setup_reads"] = setup["reads"]
    same, worst = True, 0.0
    for (te, ue, ie), (tr, ur, ir) in zip(modes["eager"].pop("res"),
                                          modes["replay"].pop("res")):
        same = same and ie == ir and torch.equal(te, tr) and torch.equal(ue, ur)
        worst = max(worst, float((ue - ur).abs().max()),
                    float((te - tr).abs().max()))
    rec.update(modes)
    rec["same_bits"], rec["max_abs_diff"] = same, worst
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
