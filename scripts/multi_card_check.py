"""The port's multi-device paths across several NVIDIA GPUs of one host.

    python3 scripts/multi_card_check.py [--cards 4] [--out FILE]

Starts one process a card (`parallel.spawn`, NCCL from a FileStore) and
runs on the ranks: `ring_knn` on one 10000-point cloud's first graph
(points_normals) and its layer-2 features; `mean_shift_iterate_sharded` on
its unit embedding; `big_cloud_segment(hpnet=True)` on one 32768-point
cloud; data-parallel `predict_shapes_mesh` on the 8 x 10000 eval (bench.py's
config 2, both models of checkpoints/bench_10k.npz); the dry run's
data-parallel train step and sharded inference (`parallel.dryrun`). This
process then computes each on card 0 alone and compares: the same
neighbour indices, the shift within 1e-6, the big cloud's and the eval's
partitions by ARI (and the eval's metrics), the dry run by `check_dryrun`.
Prints one JSON line a case, the cards' names and power limits first; the
ranks' wall seconds beside one card's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# batch, points, k and the big cloud's points; --rehearse: a CPU run of
# gloo ranks at a small size, to check the script itself
SIZES = {"batch": 8, "points": 10000, "k": 64, "big": 32768}
REHEARSAL = {"batch": 4, "points": 800, "k": 16, "big": 1600}


def _inputs(sz):
    import numpy as np
    import torch
    from sednet_tpu_torch.predict import headline_shapes

    shapes, x_np = headline_shapes(sz["batch"], sz["points"])
    _, big_np = headline_shapes(1, sz["big"])
    gen = torch.Generator().manual_seed(8)
    x0 = torch.randn((sz["big"], 12), generator=gen)
    sel = torch.randperm(sz["big"], generator=gen)[:5000]
    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    return x_np, big_np[0], x0, sel, batch


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cases(mesh, models, x, big, x0, sel, batch, timed, sz):
    """Every case on `mesh` (a Mesh of one or more ranks); each case's
    wall seconds in `timed`."""
    import numpy as np
    import torch
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.ops.knn import knn_indices_points_normals
    from sednet_tpu_torch.parallel import (big_cloud_segment,
                                           mean_shift_iterate_sharded,
                                           ring_knn)
    from sednet_tpu_torch.parallel.mesh import all_gather_rows, local_rows
    from sednet_tpu_torch.predict import forward, predict_shapes_mesh

    def clock(name, fn):
        _sync(mesh.device)
        t0 = time.time()
        out = fn()
        _sync(mesh.device)
        timed[name] = time.time() - t0
        return out

    k = sz["k"]
    out = {}
    model = models["inst"]
    with torch.no_grad():
        x1 = model.encoder.conv1(x[:1], knn_indices_points_normals(
            x[:1], k))[0].contiguous()
    sl = local_rows(sz["points"], mesh)
    for name, rows, metric in (("ring_knn layer 1", x[0], "points_normals"),
                               ("ring_knn layer 2", x1, "sqdist")):
        idx, _ = clock(name, lambda: ring_knn(rows[sl].contiguous(), k, mesh,
                                              metric=metric))
        out[name] = all_gather_rows(idx, mesh).cpu()
    emb = forward(model, x[:1])[0][0].contiguous()
    bw = float(compute_bandwidth(emb, 5000, np.float32(0.015),
                                 generator=torch.Generator().manual_seed(0)))
    out["mean_shift_sharded"] = all_gather_rows(clock(
        "mean_shift_sharded", lambda: mean_shift_iterate_sharded(
            emb[sl].contiguous(), bw, mesh, iterations=50)), mesh).cpu()
    labels, num, _, _ = clock("big_cloud_segment", lambda: big_cloud_segment(
        model, big, mesh, hpnet=True, x0=x0, sel=sel))
    out["big_cloud_segment"] = (labels.cpu().numpy(), num)
    cfg = Config(num_points=sz["points"], knn=k, embed=128,
                 hpnet_embed=True, ms_num_samples=5000)
    res = clock("predict_shapes_mesh", lambda: predict_shapes_mesh(
        models["type"], models["inst"], batch, cfg, mesh,
        generator=torch.Generator().manual_seed(6)))
    out["predict"] = [{k: r[k] for k in ("cluster_ids", "num_clusters",
                                         "inst_iou", "type_iou",
                                         "inst_recall")} for r in res]
    return out


def _models(sz, device):
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.predict import load_models

    return load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                       Config(knn=sz["k"]), device=device)


def rank_main(mesh, sz):
    """One rank: the cases over every rank, then the dry run."""
    import torch
    from sednet_tpu_torch.parallel.dryrun import dryrun_rank

    x_np, big_np, x0, sel, batch = _inputs(sz)
    timed = {}
    out = _cases(mesh, _models(sz, mesh.device),
                 torch.from_numpy(x_np).to(mesh.device),
                 torch.from_numpy(big_np).to(mesh.device), x0, sel, batch,
                 timed, sz)
    out["dryrun"] = dryrun_rank(mesh)
    out["seconds"] = timed
    return out


def _ari(a, b):
    import numpy as np

    a = np.unique(a, return_inverse=True)[1]
    b = np.unique(b, return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(table, (a, b), 1)

    def pairs(v):
        return float((v * (v - 1) / 2).sum())

    total = len(a) * (len(a) - 1) / 2
    sa, sb = pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / total
    top = 0.5 * (sa + sb) - expected
    return 1.0 if top == 0 else (pairs(table) - expected) / top


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true",
                    help="gloo ranks on the CPU at a small size")
    args = ap.parse_args()

    import subprocess

    import numpy as np
    import torch
    from sednet_tpu_torch.parallel.dryrun import check_dryrun
    from sednet_tpu_torch.parallel.mesh import Mesh, spawn

    sz = REHEARSAL if args.rehearse else SIZES
    if not args.rehearse and torch.cuda.device_count() < args.cards:
        sys.exit(f"multi_card_check: {args.cards} cards asked for, "
                 f"{torch.cuda.device_count()} present")
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    if not args.rehearse:
        emit({"cards": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()})
    t0 = time.time()
    ranks = spawn("multi_card_check:rank_main", args.cards, sz,
                  device="cpu" if args.rehearse else None, timeout=1200.0)
    emit({"ranks_wall_s": time.time() - t0, "seconds": ranks["seconds"]})

    dev = torch.device("cpu" if args.rehearse else "cuda", 0)
    x_np, big_np, x0, sel, batch = _inputs(sz)
    timed = {}
    one = _cases(Mesh(0, 1, dev), _models(sz, dev),
                 torch.from_numpy(x_np).to(dev),
                 torch.from_numpy(big_np).to(dev), x0, sel, batch, timed, sz)
    emit({"one_card_seconds": timed})
    ok = True
    for name in ("ring_knn layer 1", "ring_knn layer 2"):
        same = bool(np.array_equal(ranks[name], one[name].numpy()))
        ok &= same
        emit({"case": name, "same_indices": same})
    diff = float(np.abs(ranks["mean_shift_sharded"]
                        - one["mean_shift_sharded"].numpy()).max())
    ok &= diff <= 1e-6
    emit({"case": "mean_shift_sharded", "max_abs_diff": diff, "tol": 1e-6})
    a = _ari(ranks["big_cloud_segment"][0], one["big_cloud_segment"][0])
    ok &= a >= 0.97
    emit({"case": "big_cloud_segment", "ari": a,
          "num_clusters": [int(ranks["big_cloud_segment"][1]),
                           int(one["big_cloud_segment"][1])]})
    aris = [_ari(g["cluster_ids"], w["cluster_ids"])
            for g, w in zip(ranks["predict"], one["predict"])]
    means = {m: [float(np.mean([r[m] for r in side]))
                 for side in (ranks["predict"], one["predict"])]
             for m in ("inst_iou", "type_iou", "inst_recall")}
    ok &= min(aris) >= 0.97
    emit({"case": "predict_shapes_mesh", "ari": aris, "means": means})
    rec = check_dryrun(ranks["dryrun"], args.cards,
                       "cpu" if args.rehearse else None)
    emit({"case": "dryrun", **rec})
    emit({"ok": bool(ok)})
    if args.out:
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
