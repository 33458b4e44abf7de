"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the exit code
is not 0):

  build      builds the CUDA kernels of `sednet_tpu_torch/csrc/` with nvcc
             for sm_90a and prints the card's name and power limit;
  kernels    holds each kernel against its plain PyTorch version on the
             card at the headline shapes, and times kernel, plain version,
             one library call, and the bound the card sets;
  headline   the port's main path: 8 eval clouds of 10000 points through
             the trained `inst` weights of `checkpoints/bench_10k.npz`
             (`segment_batch`: forward, then guarded mean-shift per shape),
             with every kernel's launch count from one run, shapes/s, and
             inst/type IoU held against the JAX package's numbers;
  cluster_batch  the batched clustering path (kernel K2b) on the same
             embeddings, held against the per-shape path.

The line before the last is the `kernels` summary, the last line the
device record. Without a CUDA device, or outside a checkout of the repo,
it exits with an error and prints no result. nvcc's full register report
is in `build.log` beside the built library.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Per-shape matched IoU of the JAX package's headline pipeline on the same 8
# eval shapes and checkpoint, run on the CPU:
#   JAX_PLATFORMS=cpu python scripts/jax_headline_reference.py
REF_INST_IOU = [0.9104403419368645, 0.9029878112073358, 0.8623391918828099,
                0.8843708300624379, 0.9915031945704498, 0.9615274519939141,
                0.9253762065927553, 0.6680413992171479]
REF_TYPE_IOU = [1.0] * 8
IOU_TOL = 0.03  # bandwidth subsamples come from different RNGs
# K1 may swap neighbours only inside a near-tie, at the distance of the one
# it replaced, and in at most this share of the rows
MAX_SWAPPED = 0.01

PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3

BATCH, N_POINTS, K = 8, 10000, 64
DEVICE = "cuda"


def emit(rec):
    print(json.dumps(rec), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    from sednet_tpu_torch.ops import _build

    t0 = time.time()
    path = _build.build()
    _build.lib()
    log = _build.build_info.get("log", "")
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    card = nvidia_smi()
    print(card, flush=True)
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 2),
          "nvcc_seconds": _build.build_info.get("seconds"),
          "library": os.path.relpath(path, ROOT), "card": card,
          "ptxas": regs[:12]})
    return card


def _knn_inputs(model, x):
    """The inputs of the forward's second and third kNN graphs (the
    first graph's input is x itself)."""
    import torch
    from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals

    enc = model.encoder
    with torch.no_grad():
        x1 = enc.conv1(x, knn_indices_points_normals(x, K))
        x2 = enc.conv2(x1, knn_indices(x1, K))
    return x1, x2


def check_topk(name, q, p, k, metric="sqdist", library=True):
    """K1 against topk_plain, by `compare_with_plain`: distances, returned
    and to the returned neighbours, within 1e-5 of the rounding scale
    1 + max |q|^2; neighbour sets equal except where the plain k-th and
    (k+1)-th distances lie within 1e-6 of it, and then in at most
    MAX_SWAPPED of the rows."""
    import torch
    from sednet_tpu_torch.ops.flash_topk import (compare_with_plain,
                                                 flash_topk, topk_plain)

    idx, dist = flash_topk(q, p, k, metric=metric, return_distances=True)
    torch.cuda.synchronize()
    cmp = compare_with_plain(q, p, k, idx, dist, metric=metric)
    if (cmp["bad_rows"] or max(cmp["max_abs_err"], cmp["nbr_err"]) > cmp["tol"]
            or cmp["swapped_rows"] > MAX_SWAPPED * cmp["rows"]):
        raise AssertionError(f"{name}: {cmp}")
    b = q.shape[0] if q.dim() == 3 else 1
    m, d = q.shape[-2:]
    n = p.shape[-2]
    flops = b * m * n * (2 * 6 + 7 if metric == "points_normals" else 2 * d + 3)
    nbytes = 4 * (q.numel() + p.numel()) + 8 * b * m * k
    bms, by = bound_ms(flops, nbytes)
    rec = {"case": name, "shape": list(q.shape), "k": k, "metric": metric,
           **cmp,
           "ms": time_ms(lambda: flash_topk(q, p, k, metric=metric)),
           "plain_ms": time_ms(lambda: topk_plain(q, p, k, metric=metric),
                               reps=10, warmup=1),
           "library_ms": (time_ms(lambda: torch.topk(
               torch.cdist(q, p), k, largest=False)) if library else None),
           "bound_ms": bms, "bound_by": by}
    return rec


def _tol_trace(step, x, iterations=50, tol=1e-6):
    cur, deltas = x, []
    for _ in range(iterations):
        nxt = step(cur)
        deltas.append(float((nxt - cur).abs().max()))
        cur = nxt
    exit_after = next((i + 1 for i, d in enumerate(deltas) if d <= tol), None)
    return {"exit_after": exit_after, "min_delta": min(deltas),
            "last_delta": deltas[-1]}


def phase_kernels(model, x, emb):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.predict import HEADLINE

    out = {}
    x1, x2 = _knn_inputs(model, x)
    gen = torch.Generator().manual_seed(0)
    ns = HEADLINE.ms_num_samples
    sel = torch.randperm(N_POINTS, generator=gen)[:ns].to(emb.device)
    xs = emb[0][sel].contiguous()
    out["K1"] = [
        check_topk("knn layer 1 (points_normals)", x, x, K, "points_normals",
                   library=False),
        check_topk("knn layer 2", x1, x1, K),
        check_topk("knn layer 3", x2, x2, K),
        check_topk("bandwidth", xs, xs, 128),
    ]

    # K2 / K2b: one step from the embeddings at each shape's bandwidth
    bw = torch.stack([torch.clamp_min(compute_bandwidth(
        emb[i], ns, np.float32(HEADLINE.ms_quantile), generator=gen), 0.003)
        for i in range(BATCH)])
    inv_b2 = 1.0 / (bw * bw)
    # yardstick: attention with q scaled by 1/b^2 is the same normalised
    # kernel-weighted mean (the -1 cancels in the ratio; the -75 clamp only
    # moves weights below e^-75 of a row's own)
    sdpa = lambda n: F.normalize(F.scaled_dot_product_attention(  # noqa: E731
        (emb[:n] * inv_b2[:n, None, None])[:, None], emb[:n, None],
        emb[:n, None], scale=1.0)[:, 0], dim=-1, eps=1e-12)
    cases = []
    for name, fn, plain, lib, b in (
            ("K2", lambda: ck.mean_shift_step(emb[0], emb[0], bw[0]),
             lambda: ck.mean_shift_step_plain(emb[:1], emb[:1], inv_b2[:1])[0],
             lambda: sdpa(1)[0], 1),
            ("K2b", lambda: ck.mean_shift_step_batched(emb, emb, bw),
             lambda: ck.mean_shift_step_plain(emb, emb, inv_b2),
             lambda: sdpa(BATCH), BATCH)):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > 1e-5:
            raise AssertionError(f"{name}: max abs error {err} > 1e-5")
        e = emb.shape[-1]
        bms, by = bound_ms(b * N_POINTS * N_POINTS * (4 * e + 4),
                           4 * 3 * b * N_POINTS * e)
        cases.append({"case": name, "shape": [b, N_POINTS, e],
                      "max_abs_err": err, "tol": 1e-5,
                      "ms": time_ms(fn), "plain_ms": time_ms(plain),
                      "library_ms": time_ms(lib),
                      "bound_ms": bms, "bound_by": by})
    # where the tol test (max movement <= 1e-6) would stop the shift loop
    # of shape 0, with the kernel's and with the plain version's rounding
    cases[0]["tol_exit"] = {
        "kernel": _tol_trace(lambda c: ck.mean_shift_step(c, emb[0], bw[0]),
                             emb[0]),
        "plain": _tol_trace(lambda c: ck.mean_shift_step_plain(
            c[None], emb[:1], inv_b2[:1])[0], emb[0])}
    out["K2"], out["K2b"] = [cases[0]], [cases[1]]

    # K3: tie-heavy rows and columns (a vocabulary of 40 unit vectors), the
    # three NMS pass configurations; indices must be identical
    rng = np.random.RandomState(0)
    voc = rng.randn(40, 128).astype(np.float32)
    voc /= np.linalg.norm(voc, axis=1, keepdims=True)
    dev = x.device
    rows = torch.from_numpy(voc[rng.randint(0, 40, N_POINTS)]).to(dev)
    cols = torch.from_numpy(voc[rng.randint(0, 40, N_POINTS)]).to(dev)
    counts = torch.from_numpy(
        rng.randint(0, 5, N_POINTS).astype(np.float32)).to(dev)
    mask = torch.where(torch.from_numpy(rng.rand(N_POINTS) < 0.2).to(dev),
                       0.0, float("-inf"))
    zeros = torch.zeros(N_POINTS, device=dev)
    inf = float("inf")
    k3 = []
    for name, bias, thresh, gain in (("membership", zeros, inf, 1.0),
                                     ("vote", counts, float(bw[0]), 0.0),
                                     ("assign", mask, inf, 1.0)):
        bk, ik = ck.colmax(rows, cols, bias, thresh, gain)
        bp, ip = ck.colmax_plain(rows, cols, bias, thresh, gain)
        torch.cuda.synchronize()
        err = float((bk - bp).abs().nan_to_num(0.0).max())
        if err > 1e-5 or not torch.equal(ik, ip):
            raise AssertionError(f"K3 {name}: value error {err}, "
                                 f"{int((ik != ip).sum())} indices differ")
        bms, by = bound_ms(N_POINTS * N_POINTS * (2 * 128 + 4),
                           4 * (2 * N_POINTS * 128 + 3 * N_POINTS))
        k3.append({"case": name, "shape": [N_POINTS, N_POINTS, 128],
                   "max_abs_err": err, "tol": 1e-5, "indices_equal": True,
                   "ms": time_ms(lambda: ck.colmax(rows, cols, bias, thresh,
                                                   gain)),
                   "plain_ms": time_ms(lambda: ck.colmax_plain(
                       rows, cols, bias, thresh, gain)),
                   "library_ms": time_ms(lambda: torch.max(
                       torch.addmm(bias, rows, cols.T), dim=1))
                   if gain == 1.0 and thresh == inf else None,
                   "bound_ms": bms, "bound_by": by})
    out["K3"] = k3
    emit({"phase": "kernels", "ok": True, "results": out})
    return out


def reset_counts():
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.ops.flash_topk import flash_topk

    for fn in (flash_topk, ck.mean_shift_step, ck.mean_shift_step_batched,
               ck.colmax):
        fn.launches = 0


def read_counts():
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.ops.flash_topk import flash_topk

    return {"K1": flash_topk.launches, "K2": ck.mean_shift_step.launches,
            "K2b": ck.mean_shift_step_batched.launches,
            "K3": ck.colmax.launches}


def phase_headline(model, x, shapes):
    import numpy as np
    import torch
    from sednet_tpu_torch.metrics import batch_iou
    from sednet_tpu_torch.predict import forward, segment_batch

    gen = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    labels, types = segment_batch(model, x, generator=gen)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("K1", "K2", "K3"):
        if counts[name] <= 0:
            raise AssertionError(f"main path launched {name} no time")
    labels_np, types_np = labels.cpu().numpy(), types.cpu().numpy()
    if labels_np.shape != (BATCH, N_POINTS) or labels_np.min() < 0:
        raise AssertionError(f"bad labels {labels_np.shape}")
    inst, typ, per = batch_iou(shapes, labels_np, types_np)
    ref_inst, ref_type = float(np.mean(REF_INST_IOU)), float(np.mean(REF_TYPE_IOU))
    ok = abs(inst - ref_inst) <= IOU_TOL and abs(typ - ref_type) <= IOU_TOL

    ts, runs = [], []
    for _ in range(10):
        t0 = time.time()
        lab, ty = segment_batch(model, x, generator=gen)
        torch.cuda.synchronize()
        ts.append(time.time() - t0)
        runs.append(batch_iou(shapes, lab.cpu().numpy(), ty.cpu().numpy())[:2])
    med = float(np.median(ts))
    fw = []
    for _ in range(5):
        t0 = time.time()
        forward(model, x)
        torch.cuda.synchronize()
        fw.append(time.time() - t0)
    rec = {"phase": "headline", "ok": ok, "shapes_per_s": BATCH / med,
           "batch_s_median": med, "batch_s_min": min(ts),
           "batch_s_max": max(ts), "timing": "median of 10 synced batches",
           "forward_s_median": float(np.median(fw)),
           "inst_iou": inst, "type_iou": typ,
           "per_shape": [[a, b] for a, b in per],
           "inst_iou_over_timed_runs": float(np.mean([r[0] for r in runs])),
           "type_iou_over_timed_runs": float(np.mean([r[1] for r in runs])),
           "ref_inst_iou": ref_inst, "ref_type_iou": ref_type,
           "tol": IOU_TOL, "launches": counts,
           "peak_mem_gib": peak_gib}
    emit(rec)
    if not ok:
        raise AssertionError(f"IoU ({inst}, {typ}) not within {IOU_TOL} of "
                             f"({ref_inst}, {ref_type})")
    return counts, labels


def phase_cluster_batch(emb):
    import numpy as np
    import torch
    from sednet_tpu_torch.cluster import cluster_batch, guard_mean_shift
    from sednet_tpu_torch.predict import HEADLINE, cluster_settings

    kw = cluster_settings(HEADLINE, N_POINTS)
    gen = torch.Generator().manual_seed(2)
    sels = [torch.randperm(N_POINTS, generator=gen)[:kw["num_samples"]]
            for _ in range(BATCH)]
    reset_counts()
    labels, nums, _ = cluster_batch(emb, sels=sels, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["K2b"] <= 0:
        raise AssertionError("cluster_batch launched K2b no time")
    aris = []
    for i in range(BATCH):
        one = guard_mean_shift(emb[i], sel=sels[i], **kw)
        aris.append(_ari(labels[i].cpu().numpy(), one.labels.cpu().numpy()))
    ok = min(aris) >= 0.99
    emit({"phase": "cluster_batch", "ok": ok, "launches": counts,
          "num_clusters": nums.tolist(), "ari_vs_per_shape": aris})
    if not ok:
        raise AssertionError(f"cluster_batch ARI {min(aris)} < 0.99")
    return counts


def _ari(a, b):
    import numpy as np

    a = np.unique(a, return_inverse=True)[1]
    b = np.unique(b, return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(table, (a, b), 1)
    pairs = lambda v: float((v * (v - 1) / 2).sum())  # noqa: E731
    total = len(a) * (len(a) - 1) / 2
    sa, sb = pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / total
    top = 0.5 * (sa + sb) - expected
    return 1.0 if top == 0 else (pairs(table) - expected) / top


KERNELS = {
    "K1": ("flash_topk", "sednet_tpu_torch/csrc/flash_topk.cu",
           "sednet_tpu/ops/flash_topk.py:259"),
    "K2": ("mean_shift_step", "sednet_tpu_torch/csrc/mean_shift.cu",
           "sednet_tpu/ops/pallas_kernels.py:427"),
    "K2b": ("mean_shift_step_batched", "sednet_tpu_torch/csrc/mean_shift.cu",
            "sednet_tpu/ops/pallas_kernels.py:106"),
    "K3": ("colmax", "sednet_tpu_torch/csrc/colmax.cu",
           "sednet_tpu/ops/pallas_kernels.py:184"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(ROOT, "sednet_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)

    card = phase_build()

    from sednet_tpu_torch.predict import forward, headline_shapes, load_models

    shapes, x_np = headline_shapes(BATCH, N_POINTS)
    model = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                        which=("inst",), device=DEVICE)["inst"]
    x = torch.from_numpy(x_np).to(DEVICE)
    emb = forward(model, x)[0].contiguous()

    timings = phase_kernels(model, x, emb)
    counts, _ = phase_headline(model, x, shapes)
    counts["K2b"] = phase_cluster_batch(emb)["K2b"]

    summary = []
    for key, (name, source, replaces) in KERNELS.items():
        cases = timings[key]
        main_case = cases[1] if key == "K1" else cases[0]  # K1: layer-2 knn
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[key],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "case": main_case["case"], "parity": "ok"})
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
