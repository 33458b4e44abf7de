"""Reference quality numbers of the reference-default eval, from the JAX package.

Runs `sednet_tpu.predict.predict_shapes` -- both models of
`checkpoints/bench_10k.npz`, HPNet spectral enrichment (dense affinity and
LOBPCG at N = 10000), guarded mean-shift and the chamfer-recall ("usecd")
metrics -- under `bench.py:327`'s config,
`Config(num_points=10000, knn=64, embed=128, hpnet_embed=True,
ms_num_samples=5000)`, on the 8 eval shapes of `EVAL_STREAM_SEED`, and
prints per-shape `inst_iou`, `type_iou` and `inst_recall`.

Each shape runs as a batch of one under the key
`fold_in(PRNGKey(key), shape)`, to keep host memory small; the spread of the
numbers across keys (the LOBPCG start and the bandwidth subsamples are
random, and 10 LOBPCG iterations do not converge) is what a port that draws
its random inputs from another generator can be held to.

The PyTorch port's `chip_smoke.py` holds its `predict` phases against the
numbers this script prints.

    JAX_PLATFORMS=cpu python scripts/jax_predict_reference.py \
        [--keys 7 8 9] [--fold5drop-keys 7] [--shapes 8]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--shapes", type=int, default=8)
    p.add_argument("--points", type=int, default=10000)
    p.add_argument("--keys", type=int, nargs="*", default=[7, 8, 9])
    p.add_argument("--fold5drop-keys", type=int, nargs="*", default=[7])
    args = p.parse_args()

    import jax

    from sednet_tpu.config import Config
    from sednet_tpu.data import make_synthetic_shape, normalize_points, pca_align
    from sednet_tpu.data.synthetic import EVAL_STREAM_SEED
    from sednet_tpu.predict import (make_forward, make_tta_type_log_prob,
                                    predict_shapes)
    from sednet_tpu.train import build_model, load_params

    cfg = Config(num_points=args.points, knn=64, embed=128, hpnet_embed=True,
                 ms_num_samples=5000)
    model = build_model(cfg)
    params = load_params(os.path.join(ROOT, "checkpoints", "bench_10k.npz"))

    rng = np.random.RandomState(EVAL_STREAM_SEED)
    shapes = []
    for _ in range(args.shapes):  # bench.py:_shapes
        d = make_synthetic_shape(rng, n_points=args.points, n_segments=6)
        pts = normalize_points(d["points"])
        pts, nrm, _ = pca_align(pts, d["normals"])
        shapes.append({**d, "points": pts.astype(np.float32),
                       "normals": nrm.astype(np.float32)})

    fwd = make_forward(model)
    runs = [(k, False) for k in args.keys] + [
        (k, True) for k in args.fold5drop_keys]
    summary = {}
    for key, fold5 in runs:
        tta = make_tta_type_log_prob(model, cfg, False, fold5)
        rows = []
        for i, s in enumerate(shapes):
            t0 = time.time()
            batch = {k: s[k][None] for k in ("points", "normals", "labels",
                                             "prim")}
            res = predict_shapes(
                model, params["type"], params["inst"], batch, cfg,
                key=jax.random.fold_in(jax.random.PRNGKey(key), i),
                fold5drop=fold5, tta_fn=tta, forward_fn=fwd)[0]
            rows.append({"key": key, "fold5drop": fold5, "shape": i,
                         "inst_iou": float(res["inst_iou"]),
                         "type_iou": float(res["type_iou"]),
                         "inst_recall": float(res["inst_recall"]),
                         "num_clusters": int(res["num_clusters"]),
                         "seconds": round(time.time() - t0, 1)})
            print(json.dumps(rows[-1]), flush=True)
        name = f"key{key}" + ("_fold5drop" if fold5 else "")
        summary[name] = {m: [r[m] for r in rows]
                         for m in ("inst_iou", "type_iou", "inst_recall")}
        print(json.dumps({"run": name, **{
            m + "_mean": float(np.mean(v)) for m, v in summary[name].items()}}),
            flush=True)
    print(json.dumps({"summary": summary, "shapes": len(shapes),
                      "points": args.points,
                      "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
