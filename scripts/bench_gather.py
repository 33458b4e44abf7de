"""Time K6 (the gather-reduce of the factored edge convolution) at the
encoder's three layers under several designs for its loop and row order,
and the package's kernel beside them.

    python3 scripts/bench_gather.py [--tag NAME] [--out DIR (default build)]

Run from the root of a checkout on a machine with an NVIDIA GPU. It builds
`scripts/probe_gather_locality.cu` with nvcc (beside the package's kernels)
and, on the real layer inputs of `chip_smoke.py` (the headline batch of 8 x
10000 points through the trained inst encoder, K1's graph of each layer's
input, the signed table that `edge_conv_factored` gives K6), times:

  package        `gather_reduce` as the encoder calls it, under the Morton
                 order of the points (`locality_order`) and the identity;
  l1             the first design's loop (a warp a row, C / 32 channels a
                 lane) at W warps a block and runs of R positions of the
                 Morton order, with L1 given the SM's whole on-chip memory
                 (carveout 0) or the default split (-1);
  staged         the run's distinct neighbour rows staged in shared memory
                 (up to `cap` rows) before the same loop;
  group          the package's loop (C / 4 lanes a row, a float4 each,
                 32-bit neighbour indices, rows loaded ahead) at W warps a
                 block and runs of R positions of the Morton order;
  local_graph    the package's loop and the first design's on a graph of
                 perfect locality (every block of 64 rows reads the same 64
                 rows), the floor of each loop when L1 serves the reads;

each output held bit for bit to the package's under the identity (`ms`:
one call between CUDA events, host time included; `burst_ms`: 20 calls
back to back), with the distinct-row fraction of each order at each run
length (a count). One JSON line a layer, also written to
`<out>/bench_gather_<tag>.json`.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.getcwd()

L1_CASES = [(8, 8, 0), (8, 32, 0), (8, 64, 0), (8, 128, 0), (8, 256, 0),
            (16, 64, 0), (16, 128, 0), (16, 256, 0), (32, 128, 0),
            (32, 256, 0), (8, 64, -1), (8, 8, -1)]
# (warps, run, shared-memory KB of staged rows)
STAGED_CASES = [(8, 16, 96), (8, 32, 96), (8, 32, 192), (8, 64, 192),
                (16, 64, 192)]
# (warps, run) of the package's loop
GROUP_CASES = [(8, 16), (8, 32), (8, 64), (4, 16), (16, 64)]


def build_probe(out_dir):
    from sednet_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libprobe_gather.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                    os.path.join(ROOT, "scripts", "probe_gather_locality.cu")],
                   check=True)
    handle = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.probe_gather.argtypes = [i, i, p, p, p, i, i, i, i, i, i, p, p, p,
                                    p]
    handle.probe_gather.restype = i
    handle.probe_error_string.argtypes = [i]
    handle.probe_error_string.restype = ctypes.c_char_p
    return handle


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default="build")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_gather: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sednet_tpu_torch.ops import _build
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.graph import gather_reduce, locality_order
    from sednet_tpu_torch.predict import headline_shapes, load_models

    _build.lib()
    probe = build_probe(os.path.join(ROOT, "build", "probe_gather"))
    card = cs.nvidia_smi()
    _, x_np = headline_shapes(cs.BATCH, cs.N_POINTS)
    models = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                         device="cuda")
    x = torch.from_numpy(x_np).to("cuda")
    order = locality_order(x[..., :3].contiguous())
    ident = torch.arange(cs.N_POINTS, dtype=torch.int32, device="cuda")
    ident = ident.expand(cs.BATCH, -1).contiguous()
    lines = []
    for name, g, a, metric in cs._fused_layer_inputs(models["inst"], x):
        idx = flash_topk(g, g, cs.K, metric=metric)
        b, n, c = a.shape
        want = gather_reduce(a, idx)
        outs = [torch.empty_like(a) for _ in range(3)]

        def probe_call(design, warps, run, param, o=order):
            err = probe.probe_gather(
                design, warps, a.data_ptr(), idx.data_ptr(), o.data_ptr(), b,
                n, c, cs.K, run, param, *(t.data_ptr() for t in outs),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(probe.probe_error_string(err).decode())

        def held(fn):
            for t in outs:
                t.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            return all(torch.equal(t, w) for t, w in zip(outs, want))

        rec = {"layer": name, "shape": [b, n, cs.K, c], "card": card,
               "package_morton_ms": cs.time_ms(
                   lambda: gather_reduce(a, idx, order), reps=20),
               "package_identity_ms": cs.time_ms(
                   lambda: gather_reduce(a, idx), reps=20),
               "package_equal": all(torch.equal(u, w) for u, w in zip(
                   gather_reduce(a, idx, order), want)),
               "distinct_fraction": {
                   str(r): {"morton": cs.distinct_fraction(idx, order, r),
                            "identity": cs.distinct_fraction(idx, ident, r)}
                   for r in (8, 64, 256)},
               "l1": [], "staged": [], "group": []}
        for warps, run, carve in L1_CASES:
            def fn(warps=warps, run=run, carve=carve):
                probe_call(0, warps, run, carve)
            rec["l1"].append({"warps": warps, "run": run, "carveout": carve,
                              "equal": held(fn),
                              "ms": cs.time_ms(fn, reps=20),
                              "burst_ms": cs.burst_ms(fn)})
        for warps, run, kb in STAGED_CASES:
            cap = kb * 1024 // (4 * c)
            def fn(warps=warps, run=run, cap=cap):
                probe_call(1, warps, run, cap)
            rec["staged"].append({"warps": warps, "run": run, "cap": cap,
                                  "equal": held(fn),
                                  "ms": cs.time_ms(fn, reps=20),
                                  "burst_ms": cs.burst_ms(fn)})
        for warps, run in GROUP_CASES:
            def fn(warps=warps, run=run):
                probe_call(3, warps, run, 0)
            rec["group"].append({"warps": warps, "run": run,
                                 "equal": held(fn),
                                 "ms": cs.time_ms(fn, reps=20),
                                 "burst_ms": cs.burst_ms(fn)})
        # the first design as it ran before the order: 8 rows a block in
        # the cloud's own order
        rec["first_loop_identity_burst_ms"] = cs.burst_ms(
            lambda: probe_call(0, 8, 8, -1, ident))
        rec["first_loop_morton_burst_ms"] = cs.burst_ms(
            lambda: probe_call(0, 8, 8, -1))
        rec["package_morton_burst_ms"] = cs.burst_ms(
            lambda: gather_reduce(a, idx, order))
        rec["package_identity_burst_ms"] = cs.burst_ms(
            lambda: gather_reduce(a, idx))
        # the same table on a graph of perfect locality: the rows of each
        # block of 64 read the same 64 rows, so L1 can serve all but the
        # first reads; the floor of each loop itself
        local = (torch.arange(n, device="cuda")[:, None] // 64 * 64
                 + torch.arange(cs.K, device="cuda")[None, :]) % n
        local = local.expand(b, -1, -1).contiguous()

        def first_loop_local():
            err = probe.probe_gather(
                0, 8, a.data_ptr(), local.data_ptr(), ident.data_ptr(), b, n,
                c, cs.K, 8, -1, *(t.data_ptr() for t in outs),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(probe.probe_error_string(err).decode())

        rec["local_graph"] = {
            "package_burst_ms": cs.burst_ms(lambda: gather_reduce(a, local)),
            "first_loop_burst_ms": cs.burst_ms(first_loop_local)}
        rec["order_kernel_ms"] = cs.kernel_ms(
            lambda: locality_order(x[..., :3].contiguous()))
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_gather_{args.tag}.json"),
              "w") as f:
        json.dump(lines, f, indent=1)
    bad = [(r["layer"], v) for r in lines
           for v in r["l1"] + r["staged"] + r["group"] if not v["equal"]] + [r["layer"] for r in lines
                                 if not r["package_equal"]]
    if bad:
        sys.exit(f"bench_gather: outputs differ from the package's: {bad}")


if __name__ == "__main__":
    main()
