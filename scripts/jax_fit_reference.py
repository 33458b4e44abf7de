"""Reference numbers of the fit pipeline, from the JAX package on the CPU.

`bench.py`'s third record, "full pipeline (cluster + fits + residuals)", on
the 8 eval shapes of `EVAL_STREAM_SEED` and the trained `inst` weights of
`checkpoints/bench_10k.npz`:

  * ground truth: each shape's true labels and primitive types as the
    clustering and the predicted types, through
    `Evaluation.residual_eval_batch` (eval mode, no refit) and
    `p_coverage`: every segment's type, residual and fitted parameters
    (sign-canonicalised, `canonical_params`), each shape's residual, mean
    distance and coverage (and the count of points within 0.01);
  * end to end, for each key: the headline pipeline (the forward,
    L2-normalised embeddings, `guard_mean_shift` per shape with 5000
    samples under fold_in(PRNGKey(key), i), the type argmax), then the
    same evaluation: the batch means of residual and p_cover as
    `bench.py:full_metrics` takes them.

The PyTorch port's `chip_smoke.py` (phase `fit_pipeline`) embeds what the
last line prints. Shapes go through the forward one at a time (GroupNorm
and the global max are per shape, so this equals the batched forward).

    JAX_PLATFORMS=cpu python scripts/jax_fit_reference.py [--keys 7 8 9]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def canonical_params(v):
    """A geometric fit's parameters as a flat list, with the signs no
    distance sees fixed (the plane's (n, d) and the cylinder's axis turned
    so that their largest component is positive) and the cylinder's centre
    reduced to its component across the axis, which alone the data pin
    (chip_smoke.py holds the port's fits to these)."""
    name, parts = v[0], [np.asarray(a, np.float64).reshape(-1) for a in v[1:]]
    flat = np.concatenate(parts)
    if name in ("plane", "cylinder"):
        s = np.sign(flat[np.abs(flat[:3]).argmax()])
        flat[:4 if name == "plane" else 3] *= s
    if name == "cylinder":
        a = flat[:3] / np.linalg.norm(flat[:3])
        flat[3:6] -= (flat[3:6] @ a) * a
    return [round(float(f), 8) for f in flat]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--shapes", type=int, default=8)
    p.add_argument("--points", type=int, default=10000)
    p.add_argument("--keys", type=int, nargs="*", default=[7, 8, 9])
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from sednet_tpu.cluster import guard_mean_shift
    from sednet_tpu.config import Config
    from sednet_tpu.data import make_synthetic_shape, normalize_points, pca_align
    from sednet_tpu.data.synthetic import EVAL_STREAM_SEED
    from sednet_tpu.fit import Evaluation, FittingModule
    from sednet_tpu.fit.evaluation import p_coverage
    from sednet_tpu.train import build_model, load_params

    rng = np.random.RandomState(EVAL_STREAM_SEED)
    shapes = []
    for _ in range(args.shapes):  # bench.py:_shapes
        d = make_synthetic_shape(rng, n_points=args.points, n_segments=6)
        pts = normalize_points(d["points"])
        pts, nrm, _ = pca_align(pts, d["normals"])
        shapes.append({**d, "points": pts.astype(np.float32),
                       "normals": nrm.astype(np.float32)})
    ev = Evaluation(FittingModule())

    def evaluate(labels, types):
        t0 = time.time()
        res = ev.residual_eval_batch([
            {"points": s["points"], "normals": s["normals"],
             "labels": s["labels"].astype(np.int64),
             "cluster_ids": np.asarray(labels[i]).astype(np.int64),
             "pred_primitives": np.asarray(types[i]).astype(np.int64)}
            for i, s in enumerate(shapes)])
        cov = [p_coverage(s["points"], res[i][1])
               for i, s in enumerate(shapes)]
        return res, cov, time.time() - t0

    res, cov, secs = evaluate([s["labels"] for s in shapes],
                              [s["prim"] for s in shapes])
    gt = {"segments": [{str(k): [v[0], float(v[1]),
                                 canonical_params(r[1][k])]
                        for k, v in sorted(r[2].items())} for r in res],
          "residual": [float(r[0][0]) for r in res],
          "mean_dist": [float(c[0]) for c in cov],
          "p_cover": [float(c[1]) for c in cov],
          "covered": [int(round(c[1] * args.points)) for c in cov],
          "seconds": round(secs, 1)}
    print(json.dumps({"ground_truth": gt}), flush=True)

    cfg = Config(num_points=args.points, knn=64, embed=128)
    model = build_model(cfg)
    params = load_params(os.path.join(ROOT, "checkpoints", "bench_10k.npz"))
    variables = {"params": params["inst"]}

    @jax.jit
    def forward(xx):
        out = model.apply(variables, xx)
        emb = out.embedding / jnp.clip(
            jnp.linalg.norm(out.embedding, axis=-1, keepdims=True), min=1e-12)
        return emb, out.type_log_prob

    @jax.jit
    def cluster_one(e, k):
        return guard_mean_shift(k, e, num_samples=5000, quantile=0.015,
                                iterations=50).labels

    embs, types = [], []
    for s in shapes:
        x = np.concatenate([s["points"], s["normals"]], -1)[None]
        emb, type_lp = forward(jnp.asarray(x))
        embs.append(emb[0])
        types.append(np.asarray(type_lp[0].argmax(-1)))

    runs = {}
    for key in args.keys:
        t0 = time.time()
        k = jax.random.PRNGKey(key)
        labels = [np.asarray(cluster_one(e, jax.random.fold_in(k, i)))
                  for i, e in enumerate(embs)]
        res, cov, secs = evaluate(labels, types)
        runs[f"key{key}"] = {
            "residual": [float(r[0][0]) for r in res],
            "p_cover": [float(c[1]) for c in cov],
            "num_clusters": [int(lab.max()) + 1 for lab in labels],
            "cluster_s": round(time.time() - t0 - secs, 1),
            "eval_s": round(secs, 1)}
        print(json.dumps({f"key{key}": runs[f"key{key}"]}), flush=True)
    print(json.dumps({
        "REF_FIT_GT": {m: gt[m] for m in ("segments", "residual",
                                          "mean_dist", "p_cover", "covered")},
        "REF_FIT_KEYS": {k: {m: v[m] for m in ("residual", "p_cover")}
                         for k, v in runs.items()},
        "shapes": args.shapes, "points": args.points,
        "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
