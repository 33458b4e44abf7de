"""K6b, the gather-reduce's gradient (`csrc/gather_reduce_bwd.cu`), at the
encoder's three layer shapes on the smoke's `train` batch (4 x 10000
points, k 64, the inst model of checkpoints/bench_10k.npz), on the card:

    python3 scripts/bench_k6b.py [--parent DIR] [--out FILE]

First it checks, on this machine's CPU, that torch's `index_add_` adds in
ascending index order (the property K6b's bit equality with the plain
version rests on), then prints the card's name and power limit, then a
JSON line a layer (appended to FILE too): the in-degree's max and 99th
percentile; the transpose's device ms, K6b's own
(`sednet_graph_transpose`: CUB's radix sort on the key bits alone) and
the plain PyTorch one (`graph_transpose_plain`: torch's sort of the int32
keys), the same arrays; the device ms of one K6b call (20 calls back to
back) and its transpose, pass 1 and pass 2 apart
(`chip_smoke.k6b_passes_ms`); the first cloud against the CPU's plain
version, bit for bit. `--parent DIR` (an older checkout with the atomic
K6b of PRs 9-12, e.g. unpacked with `git archive` into build/parent)
times that tree's K6b on the same inputs (`chip_smoke.parent_k6b`).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def index_add_is_sequential(seed=0):
    """torch's CPU index_add_ against a sequential sum in ascending index
    order, bit for bit, at three shapes (up to 640000 rows)."""
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = []
    for rows, dest, c in ((40000, 500, 64), (640000, 10000, 64),
                          (200000, 3, 32)):
        src = torch.randn(rows, c, generator=gen)
        idx = torch.randint(0, dest, (rows,), generator=gen)
        got = torch.zeros(dest, c).index_add_(0, idx, src)
        order = torch.argsort(idx, stable=True)
        ends = torch.searchsorted(idx[order], torch.arange(dest),
                                  right=True).numpy()
        s = src[order].numpy()
        want = np.zeros((dest, c), np.float32)
        start = 0
        for d in range(dest):
            acc = np.zeros(c, np.float32)
            for r in range(start, ends[d]):
                acc = acc + s[r]
            want[d] = acc
            start = ends[d]
        out.append(bool(torch.equal(got, torch.from_numpy(want))))
    return all(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k6b: needs the card")
    import chip_smoke as S
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.data import BatchLoader
    from sednet_tpu_torch.ops import graph as G
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.predict import load_models

    def emit(rec):
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    emit({"cpu_index_add_sequential": index_add_is_sequential(),
          "torch": torch.__version__})
    print(S.nvidia_smi(), flush=True)
    model = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                        device="cuda", which=("inst",))["inst"]
    mixed, _ = S.train_sets()
    batch = T.to_device(next(iter(BatchLoader(mixed, 4, shuffle=False))),
                        "cuda")
    x = T.model_input(batch, True).contiguous()
    order = G.locality_order(x[..., :3].contiguous())
    gen = torch.Generator().manual_seed(S.TRAIN_SEED)
    parent = S.parent_k6b(args.parent) if args.parent else None
    with torch.no_grad():
        layers = S._fused_layer_inputs(model, x)
    for name, g, a, metric in layers:
        idx = flash_topk(g, g, S.K, metric=metric)
        b, n, c = a.shape
        k = idx.shape[-1]
        mx = G.gather_reduce_plain(a, idx)[2]
        cot = [torch.randn((b, n, c), generator=gen).to("cuda")
               for _ in range(3)]
        ends, eids = G._transpose_launch(idx, n)
        plain_t = G.graph_transpose_plain(idx, n)
        deg = torch.diff(ends, prepend=ends.new_zeros(1))

        def call():
            return G._gather_reduce_backward_launch(a, idx, order, mx, *cot)

        got = call()[:1].cpu()
        want = G.gather_reduce_backward_plain(
            *(t[:1].cpu() for t in (a, idx, mx, *cot)))
        emit({"layer": name, "shape": [b, n, k, c],
              "in_degree_max": int(deg.max()),
              "in_degree_p99": float(torch.quantile(deg.double(), 0.99)),
              "transpose_ms": S.burst_ms(lambda: G._transpose_launch(idx, n)),
              "transpose_torch_ms": S.burst_ms(
                  lambda: G.graph_transpose_plain(idx, n)),
              "transpose_equal": bool(torch.equal(ends, plain_t[0])
                                      and torch.equal(eids, plain_t[1])),
              "device_ms": S.burst_ms(call),
              "split": S.k6b_passes_ms(a, idx, order, mx, cot),
              "first_cloud_equal_cpu_plain": torch.equal(got, want)})
        if parent is not None:
            emit({"layer": name, "parent_device_ms": S.burst_ms(
                      lambda: parent(a, idx, order, mx, cot)),
                  "parent_ms": S.time_ms(
                      lambda: parent(a, idx, order, mx, cot), reps=20)})


if __name__ == "__main__":
    main()
