"""Reference quality numbers of the headline pipeline, from the JAX package.

Runs the same steps as `bench.py`'s headline `pipeline` -- the SEDNet
forward on the trained `inst` weights of `checkpoints/bench_10k.npz`,
L2-normalised embeddings, `guard_mean_shift` per shape (num_samples=5000,
quantile=0.015, 50 iterations, the default tol) and the matched inst/type
IoU of `bench.py:batch_metrics` -- on the 8 eval shapes of
`EVAL_STREAM_SEED`. Shapes go through the forward one at a time (GroupNorm
and the global max are per shape, so this equals the batched forward) to
keep host memory small.

The PyTorch port's `chip_smoke.py` holds its batch means against the
per-shape numbers this script prints.

    JAX_PLATFORMS=cpu python scripts/jax_headline_reference.py [--shapes 8]
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
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from sednet_tpu.cluster import guard_mean_shift
    from sednet_tpu.config import Config
    from sednet_tpu.data import make_synthetic_shape, normalize_points, pca_align
    from sednet_tpu.data.synthetic import EVAL_STREAM_SEED
    from sednet_tpu.metrics import siou_matched_segments, to_one_hot
    from sednet_tpu.train import build_model, load_params

    cfg = Config(num_points=args.points, knn=64, embed=128)
    model = build_model(cfg)
    params = load_params(os.path.join(ROOT, "checkpoints", "bench_10k.npz"))
    variables = {"params": params["inst"]}

    rng = np.random.RandomState(EVAL_STREAM_SEED)
    shapes = []
    for _ in range(args.shapes):  # bench.py:_shapes
        d = make_synthetic_shape(rng, n_points=args.points, n_segments=6)
        pts = normalize_points(d["points"])
        pts, nrm, _ = pca_align(pts, d["normals"])
        shapes.append({**d, "points": pts.astype(np.float32),
                       "normals": nrm.astype(np.float32)})

    @jax.jit
    def forward(xx):
        out = model.apply(variables, xx)
        emb = out.embedding / jnp.clip(
            jnp.linalg.norm(out.embedding, axis=-1, keepdims=True), min=1e-12)
        return emb, out.type_log_prob

    @jax.jit
    def cluster_one(e, k):
        return guard_mean_shift(k, e, num_samples=5000, quantile=0.015,
                                iterations=50)

    key = jax.random.PRNGKey(1)
    rows = []
    for i, s in enumerate(shapes):
        t0 = time.time()
        x = np.concatenate([s["points"], s["normals"]], -1)[None]
        emb, type_lp = forward(jnp.asarray(x))
        res = cluster_one(emb[0], jax.random.fold_in(key, i))
        labels = np.asarray(res.labels)
        types = np.asarray(type_lp[0].argmax(-1))
        w = to_one_hot(labels, max(int(labels.max()) + 1, 1))
        s_iou, p_iou, _, _, _ = siou_matched_segments(
            s["labels"].astype(np.int64), labels.astype(np.int64),
            types.astype(np.int64), s["prim"].astype(np.int64), w)
        rows.append({"shape": i, "inst_iou": float(s_iou),
                     "type_iou": float(p_iou),
                     "num_clusters": int(res.num_clusters),
                     "bandwidth": float(res.bandwidth),
                     "seconds": round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "inst_iou_mean": float(np.mean([r["inst_iou"] for r in rows])),
        "type_iou_mean": float(np.mean([r["type_iou"] for r in rows])),
        "shapes": len(rows), "points": args.points,
        "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
