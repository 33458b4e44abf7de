"""The reference-default eval with ms_bf16 on and off, on one NVIDIA GPU.

    python3 scripts/bench_eval_ms_bf16.py [--tree DIR] [--reps N] [--out FILE]

Runs the `phase_predict` of the tree DIR's `chip_smoke.py` (default: this
checkout; or an older one, unpacked with `git archive` into build/parent)
on the inputs of the smoke's `ms_bf16` phase: bench.py's config 2 on the
8 x 10000 headline clouds, the same injected LOBPCG starts and subsamples,
float32 first, then with ms_bf16. Each run's first batch is untimed (it
builds the kernels and holds the metrics to JAX's bars); then --reps
synced batches (median, min and max, host clock). Prints one JSON line a
run, with the card's name and power limit, the tree and the run's
launches. To compare two trees, call it once a tree in one chip call, in
the order parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    import chip_smoke as cs
    from sednet_tpu_torch.predict import headline_shapes, load_models

    if not torch.cuda.is_available():
        sys.exit("bench_eval_ms_bf16: no CUDA device")
    shapes, _ = headline_shapes(cs.BATCH, cs.N_POINTS)
    models = load_models(os.path.join(tree, "checkpoints", "bench_10k.npz"),
                         device="cuda")
    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    # the ms_bf16 phase's injected inputs (`chip_smoke.phase_ms_bf16`)
    gen = torch.Generator().manual_seed(3)
    x0s = [torch.randn((cs.N_POINTS, 12), generator=gen)
           for _ in range(cs.BATCH)]
    sels = [torch.randperm(cs.N_POINTS, generator=gen)[:5000]
            for _ in range(cs.BATCH)]
    keep = ("ok", "shapes_per_s", "batch_s_median", "batch_s_min",
            "batch_s_max", "inst_iou", "type_iou", "inst_recall", "launches")
    lines = []
    for name, bf16 in (("f32", False), ("bf16", True)):
        rec, _, _ = cs.phase_predict(
            f"ms_bf16/{name}", models, batch, (x0s, sels), reps=args.reps,
            cfg=cs.predict_cfg(ms_bf16=bf16), profiled=False)
        line = {"card": cs.nvidia_smi(), "tree": os.path.relpath(tree, ROOT),
                "run": name, "timed_batches": args.reps,
                **{k: rec[k] for k in keep}}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
