"""Time the port's headline and its K1 and K6 calls through one source tree,
to compare the ctypes-bound wrappers of one tree with the `torch.library`
ops of another on the same card.

    python3 scripts/bench_custom_ops.py --root DIR --tag NAME [--out FILE]

DIR is a checkout of the repository (this one, or an older commit unpacked
with `git archive` into a directory that .gitignore lists, e.g.
build/parent); its `sednet_tpu_torch` is imported and its kernels built
there. Run the trees in turns in one call (A, B, B, A): each run prints
one JSON line (appended to FILE too) with

  * headline_batch_s: `predict.segment_batch` on the 8 eval clouds of
    10000 points (checkpoints/bench_10k.npz, inst), median of 5 synced
    batches after one warm-up;
  * k1_layer2_ms / k6_layer2_ms: the smoke's main K1 and K6 cases (the
    encoder's layer-2 graph, k 64 on the 64-wide layer-1 features, and the
    layer-2 gather-reduce of the signed table along the Morton order),
    median of 10 CUDA-event timings of one call each, host dispatch
    included;
  * k1_tiny_us / k6_tiny_us: one call at a tiny shape (256 rows, k 8),
    where the host's cost per call (the dispatcher's, or ctypes') is what
    the timing sees: the wall of 200 calls back to back, then a sync.

It needs the card and prints the card's name and power limit first.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_custom_ops: needs the card")
    import sednet_tpu_torch
    from sednet_tpu_torch.ops import _build
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.graph import gather_reduce, locality_order
    from sednet_tpu_torch.predict import (headline_shapes, load_models,
                                          segment_batch)

    if not sednet_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {sednet_tpu_torch.__file__}, not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    _build.lib()
    build_s = time.time() - t0

    def events_ms(fn, reps=10, warmup=2):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def host_us(fn, calls=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    _, x_np = headline_shapes(8, 10000)
    model = load_models(os.path.join(root, "checkpoints", "bench_10k.npz"),
                        device="cuda", which=("inst",))["inst"]
    x = torch.from_numpy(x_np).cuda()
    gen = torch.Generator().manual_seed(1)
    segment_batch(model, x, generator=gen)
    torch.cuda.synchronize()
    batches = []
    for _ in range(5):
        t = time.time()
        segment_batch(model, x, generator=gen)
        torch.cuda.synchronize()
        batches.append(time.time() - t)

    enc = model.encoder
    with torch.no_grad():
        idx1 = flash_topk(x, x, 64, metric="points_normals")
        order = locality_order(x[..., :3].contiguous())
        x1 = enc.conv1(x, idx1, order).contiguous()
        idx2 = flash_topk(x1, x1, 64)
        w = enc.conv2.conv.weight
        a = torch.nn.functional.linear(x1, w[:, :64])
        sign = torch.where(enc.conv2.gn.weight >= 0, 1.0, -1.0)
        table = (a * sign).contiguous()
        k1 = events_ms(lambda: flash_topk(x1, x1, 64))
        k6 = events_ms(lambda: gather_reduce(table, idx2, order))
        rng = np.random.RandomState(0)
        q = torch.from_numpy(rng.randn(1, 256, 8).astype(np.float32)).cuda()
        t = torch.from_numpy(rng.randn(1, 256, 32).astype(np.float32)).cuda()
        ti = flash_topk(q, q, 8)
        k1_tiny = host_us(lambda: flash_topk(q, q, 8))
        k6_tiny = host_us(lambda: gather_reduce(t, ti))
    rec = {"tag": args.tag, "root": os.path.relpath(root, os.getcwd()),
           "card": card, "build_s": build_s,
           "headline_batch_s": float(np.median(batches)),
           "headline_batch_s_all": batches,
           "k1_layer2_ms": k1, "k6_layer2_ms": k6,
           "k1_tiny_us": k1_tiny, "k6_tiny_us": k6_tiny,
           "custom_ops": hasattr(torch.ops.sednet, "topk")}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
