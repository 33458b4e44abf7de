"""Frozen arithmetic of the benchmark: the H100's peaks, and the dense
operations and bytes that the work of a cell needs, counted from shapes.

Peaks: NVIDIA H100 SXM data sheet, dense rates. A float32-accurate
product on the tensor cores takes three TF32 products (the split of the
port's `csrc/sim_tile.cuh`), so its rate is a third of TF32's. Every count
is of products as the plain reference runs them (`reference.py`), each
product once: 2 m n k operations for an (m, k) x (k, n) product.
"""
from __future__ import annotations

PEAK = {
    "tf32": 495e12,        # TF32 tensor cores, FLOP/s
    "bf16": 989e12,        # bf16 tensor cores, FLOP/s
    "fp32": 67e12,         # float32 outside the tensor cores, FLOP/s
    "fp32_split": 495e12 / 3,  # float32-accurate products as 3 TF32 products
    "hbm": 3.35e12,        # HBM3 bytes/s
}
F32 = 4


def mm(m: int, k: int, n: int) -> float:
    """Operations of an (m, k) x (k, n) product."""
    return 2.0 * m * k * n


def roofline_s(flops: float, nbytes: float, peak: str) -> float:
    """The least time of a launch: the larger of its operations over the
    peak rate `peak` and its bytes over the HBM rate."""
    return max(flops / PEAK[peak], nbytes / PEAK["hbm"])


def knn_flops(n: int, d: int) -> float:
    """The distance products of one exact kNN graph of n rows of width d
    against themselves (the reference's (n, d) x (d, n) product)."""
    return mm(n, d, n)


def knn_bytes(n: int, d: int, k: int) -> float:
    """One graph's bytes: the rows read once, the (n, k) int64 ids
    written."""
    return n * d * F32 + n * k * 8


def knn_launch_peak(d: int) -> str:
    """K1 multiplies on the TF32 split above width 8 and in plain float32
    at or below it (the 3-wide xyz and 6-wide first-layer graphs)."""
    return "fp32_split" if d > 8 else "fp32"


def sednet_graphs(mode: int = 5):
    """(width, channels out) of the three graphs of the encoder: the
    first-layer graph on xyz and normals (two 3-wide products), the other
    two on the 64-wide features."""
    first = 6 if mode == 5 else 3
    return [(first, 64), (64, 64), (64, 128)]


def sednet_forward_flops(n: int, k: int, emb: int = 128, types: int = 6,
                         mode: int = 5, first_graph: bool = True) -> dict:
    """Products of one SEDNet forward on one cloud of n points, as the
    plain reference runs it: the kNN distance products of its graphs
    (`first_graph` False when a shared first-layer graph is given), the
    direct edge convolution on every one of the n k edges, the 1024-wide
    layer and the heads. Returns {"knn": ..., "layers": ...}."""
    c_in = 6 if mode == 5 else 3
    graphs = sednet_graphs(mode)
    knn = sum(knn_flops(n, d) for d, _ in graphs[(0 if first_graph else 1):])
    layers = mm(n * k, 2 * c_in, 64) + mm(n * k, 128, 64) + mm(n * k, 128, 128)
    layers += mm(n, 256, 1024)
    heads = [(1280, 512), (512, 256), (256, 256), (256, types), (256, 128),
             (128, 2), (256, 256), (256, 256), (types + 2, 256), (256, emb)]
    layers += sum(mm(n, a, b) for a, b in heads)
    return {"knn": knn, "layers": layers}


def bandwidth_k(quantile: float, m: int) -> int:
    """The bandwidth's neighbour rank, clip(int(q m), 1, min(m - 1, 256))."""
    import numpy as np
    return int(np.clip(int(np.float32(quantile) * np.float32(m)), 1,
                       min(m - 1, 256)))


def cluster_work(n: int, width: int, steps: int, samples: int,
                 bf16: bool) -> list:
    """The launches of one cloud's clustering as (name, flops, bytes,
    peak): the bandwidth's distance product over the subsample, `steps`
    shift steps (two (n, width) x (width, n) products each: similarities,
    then the weighted sum) and the three NMS column-max products. `width`
    is the enriched embedding's width (140 on the main path)."""
    m = min(samples, n)
    step_peak = "bf16" if bf16 else "fp32_split"
    row = n * width * F32
    out = [("bandwidth", mm(m, width, m), m * width * F32 + m * F32,
            "fp32_split")]
    out += [("shift_step", 2 * mm(n, width, n), 3 * row, step_peak)] * steps
    out += [("nms", mm(n, width, n), 2 * row + n * 8, "fp32_split")] * 3
    return out


def cluster_roofline_s(n: int, width: int, steps: int, samples: int,
                       bf16: bool) -> float:
    return sum(roofline_s(f, b, p)
               for _, f, b, p in cluster_work(n, width, steps, samples, bf16))


def eval_batch_flops(batch: int, n: int, k: int, width: int, steps: int,
                     samples: int, emb: int = 128, types: int = 6,
                     mode: int = 5) -> float:
    """The dense operations one eval batch needs: both forwards (the
    inst forward reuses the type forward's first-layer graph), the
    spectral affinity's farthest-neighbour distance product on xyz, and
    each cloud's clustering (`cluster_work`)."""
    t = sednet_forward_flops(n, k, emb, types, mode, first_graph=True)
    i = sednet_forward_flops(n, k, emb, types, mode, first_graph=False)
    per_cloud = (t["knn"] + t["layers"] + i["knn"] + i["layers"]
                 + knn_flops(n, 3)
                 + sum(f for _, f, _, _ in
                       cluster_work(n, width, steps, samples, False)))
    return batch * per_cloud


def train_step_flops(batch: int, n: int, k: int, emb: int = 128,
                     types: int = 6, mode: int = 5) -> float:
    """One train step: the forward's layer products three times (forward
    and the two products of each layer's backward) and its kNN distance
    products once (no gradient flows through a graph)."""
    f = sednet_forward_flops(n, k, emb, types, mode, first_graph=True)
    return batch * (3 * f["layers"] + f["knn"])


def train_knn_roofline_s(batch: int, n: int, k: int, mode: int = 5) -> float:
    """The roofline time of one train step's three kNN graphs."""
    return batch * sum(roofline_s(knn_flops(n, d), knn_bytes(n, d, k),
                                  knn_launch_peak(d))
                       for d, _ in sednet_graphs(mode))
