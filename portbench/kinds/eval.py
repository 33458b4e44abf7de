"""The eval runner: a closed loop of batches through the port's
reference-default eval, `predict.predict_shapes_stream` (both models, the
HPNet enrichment, `cluster_batch` with its guard, the matched metrics),
batch k+1's device half enqueued before batch k's host half.

Set-up loads the configuration's checkpoint (checked against its
digest), makes the pool of clouds from the seed and runs the stream over
`warm` batches of the cell's own shape. The window starts a fresh stream
and ends at the first batch completion after --seconds; the rate is the
shapes completed over that time.

`correct`: one completed batch of the window, drawn from the seed, is
held against the plain reference (`reference.py`). The forwards (type
log-probs, embedding, edge probabilities) are the reference's own. The
LOBPCG eigenvectors are the program's state: the enrichment is checked
from them, and each later stage (bandwidth, shift loop, NMS, metrics)
from the program's own input to that stage, so that a rounding decision
upstream cannot make a sound stage look wrong.
"""
from __future__ import annotations

import contextlib
import hashlib
import time
from itertools import islice
from pathlib import Path

import numpy as np

from portbench import counts, gen
from portbench.shared import port_config
from portbench import reference as ref
from portbench.trace import WINDOW, profiled

ROOT = Path(__file__).resolve().parents[2]


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Capture:
    """What the timed path produced for each batch in flight, kept for one
    completed batch drawn from the seed (a reservoir of one): the type
    log-probs and the inst forward (through the functions the stream is
    handed), and, through hooks on the `predict` and `cluster.spectral`
    modules, each cloud's LOBPCG Ritz pairs and eigenvectors and the
    clustering's pending state."""

    def __init__(self, seed: int, cluster_hook=None):
        self.rng = np.random.default_rng((seed, 3))
        self.cluster_hook = cluster_hook
        self.reset()

    def reset(self):
        self.live, self.kept, self.cur, self.pulled = {}, None, None, -1

    def feed(self, batches):
        for b in batches:
            self.pulled += 1
            self.cur = {"batch": b, "v": []}
            self.live[self.pulled] = self.cur
            yield b

    def type_fn(self, fn):
        def wrapped(x, idx1=None):
            out = fn(x, idx1)
            self.cur["type_lp"] = out
            return out
        return wrapped

    def inst_fn(self, fn):
        def wrapped(x, idx1=None):
            out = fn(x, idx1)
            self.cur["embedding"], self.cur["edge_logits"] = out[1], out[2]
            return out
        return wrapped

    @contextlib.contextmanager
    def hooks(self, predict):
        from sednet_tpu_torch.cluster import spectral as spectral_mod

        spectral, cluster = predict.spectral_embed, predict.cluster_batch_async
        solve = spectral_mod.lobpcg_standard

        def lobpcg_standard(*a, **k):
            theta, u, its = solve(*a, **k)
            self.cur.setdefault("ritz", []).append((theta, u, its))
            return theta, u, its

        def spectral_embed(*a, **k):
            v, ent = spectral(*a, **k)
            self.cur["v"].append(v)
            return v, ent

        def cluster_batch_async(*a, **k):
            g = k.get("generator")
            # the bandwidths' subsamples are drawn from it, shape by shape
            self.cur["draws"] = None if g is None else g.get_state()
            p = cluster(*a, **k)
            if self.cluster_hook is not None:
                self.cluster_hook(p)
            self.cur["cluster"] = p
            return p

        predict.spectral_embed = spectral_embed
        predict.cluster_batch_async = cluster_batch_async
        spectral_mod.lobpcg_standard = lobpcg_standard
        try:
            yield
        finally:
            predict.spectral_embed = spectral
            predict.cluster_batch_async = cluster
            spectral_mod.lobpcg_standard = solve

    def complete(self, j: int, results: list):
        rec = self.live.pop(j)
        rec["results"] = results
        if self.kept is None or self.rng.random() < 1.0 / (j + 1):
            self.kept = rec


def load_weights(path, device):
    """The checkpoint's arrays as flax-layout tensors per model."""
    import torch

    with np.load(path) as d:
        out = {"type": {}, "inst": {}}
        for key in d.files:
            model, name = key.split("/", 1)
            out[model][name] = torch.from_numpy(np.array(d[key], np.float32)).to(device)
    return out


def produced(rec: dict, width: int) -> dict:
    """The program's outputs of one captured batch, on the host side of
    the comparison: each tensor as the timed path left it."""
    res = rec["results"]
    pend = rec["cluster"]
    import torch

    return {"type_lp": rec["type_lp"].float(),
            "embedding": rec["embedding"].float(),
            "edge_prob": torch.from_numpy(np.stack([r["edge_prob"] for r in res])),
            "v": rec["v"], "draws": rec["draws"],
            "ritz": [(t, u) for t, u, _ in rec["ritz"]],
            "x": pend.x[..., :width].float(),
            "bw": pend.bandwidth.float(),
            "shifted": pend.shifted[..., :width].float(),
            "labels": np.stack([r["cluster_ids"] for r in res]).astype(np.int64),
            "types": np.stack([r["pred_primitives"] for r in res]).astype(np.int64),
            "metrics": np.array([[r["inst_iou"], r["type_iou"], r["inst_recall"]]
                                 for r in res], np.float64)}


def subsamples(draws, b: int, n: int, m: int) -> list:
    """Each cloud's bandwidth subsample, drawn again from the generator
    state the clustering started from (`torch.randperm(n)[:m]` a cloud,
    in order); every row where the cloud has no more than m points."""
    import torch

    if m >= n:
        return [slice(None)] * b
    g = torch.Generator()
    g.set_state(draws)
    return [torch.randperm(n, generator=g)[:m] for _ in range(b)]


def dense_affinity(cfg, batch) -> bool:
    """Whether the clouds' spectral solve takes the dense affinity: up to
    `spectral_dense_max_n` points, unless the configuration says."""
    if cfg.spectral_matfree is not None:
        return not cfg.spectral_matfree
    return batch["points"].shape[1] <= cfg.spectral_dense_max_n


def reference_forwards(weights, batch, cfg, device, prec=ref.F32):
    import torch

    x = torch.from_numpy(np.concatenate([batch["points"], batch["normals"]],
                                        -1)).to(device)
    out = {"type_lp": [], "embedding": [], "edge_logits": []}
    with torch.no_grad():
        for i in range(x.shape[0]):
            lp, _, _, g1 = ref.sednet(weights["type"], x[i:i + 1], k=cfg.knn,
                                      normal_w=cfg.normal_metric_W,
                                      w_pos=cfg.w_pos_enc, prec=prec)
            _, emb, edge, _ = ref.sednet(weights["inst"], x[i:i + 1],
                                         k=cfg.knn, w_pos=cfg.w_pos_enc,
                                         prec=prec, graph1=g1)
            out["type_lp"].append(lp[0])
            out["embedding"].append(emb[0])
            out["edge_logits"].append(edge[0])
    return {k: torch.stack(v) for k, v in out.items()}


def control_outputs(rec, weights, cfg, device, prec) -> dict:
    """The reference put in the program's place at precision `prec`: its
    forwards, its affinity and LOBPCG solve, the enrichment, its own
    bandwidth, shift loop and NMS, and the metrics of its labels. The
    bandwidths' subsamples are the program's draws (the benchmark's
    inputs)."""
    import torch

    batch = rec["batch"]
    f = reference_forwards(weights, batch, cfg, device, prec)
    gen_x0 = torch.Generator().manual_seed(0)
    ritz, vs = [], []
    with torch.no_grad():
        for i in range(batch["points"].shape[0]):
            a = ref.normal_affinity(
                torch.from_numpy(batch["points"][i]).to(device),
                torch.from_numpy(batch["normals"][i]).to(device),
                cfg.spectral_sigma, cfg.spectral_knn, prec,
                dense_affinity(cfg, batch))
            x0 = torch.randn((a.shape[0], cfg.spectral_eigvecs),
                             generator=gen_x0).to(device)
            theta, u = ref.lobpcg(a, x0, 10, prec)
            ritz.append((theta, u))
            vs.append(u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True)
                           + 1e-16))
            del a
        x = torch.stack([ref.enrich(f["embedding"][i], vs[i],
                                    cfg.normal_smooth_w, prec)
                         for i in range(len(vs))])
        sel = subsamples(rec["draws"], x.shape[0], x.shape[1],
                         cfg.ms_num_samples)
        bw = [ref.bandwidth(x[i][sel[i]], cfg.ms_quantile, prec)
              for i in range(x.shape[0])]
        shifted, _ = ref.mean_shift(x, bw, cfg.ms_iterations, cfg.ms_tol, prec)
        labels = np.stack([ref.nms(shifted[i], x[i], bw[i], prec)[0].cpu().numpy()
                           for i in range(x.shape[0])])
    types = f["type_lp"].argmax(-1).cpu().numpy()
    mets = np.array([ref.matched_metrics(batch["labels"][i].astype(np.int64),
                                         batch["prim"][i], labels[i], types[i],
                                         batch["points"][i], device)
                     for i in range(x.shape[0])], np.float64)
    return {"type_lp": f["type_lp"], "embedding": f["embedding"],
            "edge_prob": torch.softmax(f["edge_logits"], -1).cpu(),
            "v": vs, "ritz": ritz, "draws": rec["draws"], "x": x,
            "bw": torch.tensor(bw), "shifted": shifted, "labels": labels,
            "types": types, "metrics": mets}


def partition_mismatch(a, b) -> int:
    """Points on which two labelings disagree once their ids are matched
    one to one for the largest overlap: a different center picked among
    points that converged together renames a cluster and moves no point."""
    from scipy.optimize import linear_sum_assignment

    n = int(max(a.max(), b.max())) + 1
    overlap = np.zeros((n, n), np.int64)
    np.add.at(overlap, (a, b), 1)
    r, c = linear_sum_assignment(-overlap)
    return int(a.shape[0] - overlap[r, c].sum())


def _rel(a, b) -> float:
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def eig_gaps(batch, cfg, ritz, device) -> tuple:
    """Each cloud's Ritz gap (`reference.ritz_gap`, in float64) of the
    program's pairs under the reference affinity, built on the
    farthest-point graph at two float32 roundings of the same distances:
    from the product form |q|^2 - 2 q.p + |p|^2 and summed from the
    differences. A near-tie among a row's farthest points is decided by
    rounding, and the port's graph sides with one or the other. Returns
    (gaps of the product form, gaps of the difference form)."""
    import torch

    dense = dense_affinity(cfg, batch)
    k, sigma = cfg.spectral_knn, cfg.spectral_sigma
    out = ([], [])
    with torch.no_grad():
        for i, (theta, u) in enumerate(ritz):
            xyz = torch.from_numpy(batch["points"][i]).to(device)
            nrm = torch.from_numpy(batch["normals"][i]).to(device)
            theta, u = theta.double().to(device), u.double().to(device)
            for gaps, direct in zip(out, (False, True)):
                a = ref.normal_affinity(xyz, nrm, sigma, k, dense=dense,
                                        idx=ref.farthest(xyz, k, direct=direct))
                gaps.append(ref.ritz_gap(a.double(), theta, u))
                del a
    return out


def affinity_witness(batch, cfg, ritz, device, product) -> dict:
    """What `eig_gaps` rests on, for the readings (`control.py`): each
    cloud's Ritz gap under the affinity built wholly in float64; the rows
    whose farthest-point sets differ between the product form and the
    difference form and between the product form and float64; the loss
    of orthogonality of the program's eigenvectors; and, for the cloud
    whose product-form gap is the largest, where that passes 1e-5 and the
    affinity is dense, the largest relative gap of the program's Ritz
    values to the float64 affinity's top eigenvalues."""
    import torch

    dense = dense_affinity(cfg, batch)
    k, sigma = cfg.spectral_knn, cfg.spectral_sigma
    out = {"eig_f64": [], "rows_direct": [], "rows_f64": [], "orth": []}

    def rows_differ(g, h):
        return int((g.sort(1).values != h.sort(1).values).any(1).sum())

    with torch.no_grad():
        for i, (theta, u) in enumerate(ritz):
            xyz = torch.from_numpy(batch["points"][i]).to(device)
            nrm = torch.from_numpy(batch["normals"][i]).to(device)
            theta, u = theta.double().to(device), u.double().to(device)
            un = u / torch.linalg.vector_norm(u, dim=0, keepdim=True)
            out["orth"].append(float(torch.linalg.matrix_norm(
                un.T @ un - torch.eye(un.shape[1], device=device,
                                      dtype=un.dtype))))
            g32 = ref.farthest(xyz, k)
            g64 = ref.farthest(xyz.double(), k)
            out["rows_direct"].append(rows_differ(
                g32, ref.farthest(xyz, k, direct=True)))
            out["rows_f64"].append(rows_differ(g32, g64))
            a = ref.normal_affinity(xyz.double(), nrm.double(), sigma, k,
                                    dense=dense, idx=g64)
            out["eig_f64"].append(ref.ritz_gap(a, theta, u))
            del a
        worst = int(np.argmax(product))
        if dense and product[worst] > 1e-5:
            xyz = torch.from_numpy(batch["points"][worst]).to(device).double()
            nrm = torch.from_numpy(batch["normals"][worst]).to(device).double()
            a = ref.normal_affinity(xyz, nrm, sigma, k, dense=True)
            lam = torch.linalg.eigvalsh(a)[-ritz[worst][0].shape[0]:].flip(0)
            theta = ritz[worst][0].double().to(device)
            out["witness_cloud"] = worst
            out["witness_value_gap"] = float(((theta - lam).abs()
                                              / lam.abs()).max())
            del a
    return out


def compare(out: dict, batch: dict, weights, cfg, device,
            diagnose: bool = False) -> dict:
    """The numbers `correct` holds to their limits, for the outputs `out`
    of one batch (the program's, or a control's): relative L2 gaps of the
    forwards, the worst cloud's gap of the LOBPCG Ritz pairs under the
    reference's own affinity at the nearer of its two roundings
    (`eig_gaps`), the relative L2 gap of the enriched embedding built
    from the eigenvectors, the worst cloud's relative bandwidth gap, the
    shifted points' distances to the reference's held cloud by cloud
    (the worst cloud's median and its 99th percentile: a point near a
    basin's edge may go another way on rounding alone, so the widest gap
    would measure those points and not the steps, while a quantile of
    each cloud fails a fault that spares the other clouds or most of a
    cloud's rows), and the widest gap of the matched metrics computed
    again from the program's labels and types (exact). diagnose: the
    info also holds each cloud's Ritz gaps and shift quantiles and
    `affinity_witness`."""
    import torch

    f = reference_forwards(weights, batch, cfg, device)
    max_clusters = cfg.ms_max_clusters - 1
    with torch.no_grad():
        x = out["x"].to(device)
        enriched = torch.stack([ref.enrich(f["embedding"][i], out["v"][i].float(),
                                           cfg.normal_smooth_w)
                                for i in range(x.shape[0])])
        sel = subsamples(out["draws"], x.shape[0], x.shape[1],
                         cfg.ms_num_samples)
        bw = [ref.bandwidth(x[i][sel[i]], cfg.ms_quantile)
              for i in range(x.shape[0])]
        bw_out = out["bw"].double().cpu().numpy()
        product, direct = eig_gaps(batch, cfg, out["ritz"], device)
        shifted, steps = ref.mean_shift(x, bw, cfg.ms_iterations, cfg.ms_tol)
        shifted_out = out["shifted"].to(device)
        gaps = torch.linalg.vector_norm((shifted_out - shifted).double(), dim=-1)
        q = torch.quantile(gaps, torch.tensor([0.5, 0.99], device=device,
                                              dtype=gaps.dtype), dim=1).cpu()
        mism, points, retried = 0, 0, 0
        for i in range(x.shape[0]):
            lab, n_c = ref.nms(shifted_out[i], x[i], float(bw_out[i]))
            if n_c > max_clusters:
                retried += 1     # the guard re-clustered it: no replay
                continue
            mism += partition_mismatch(lab.cpu().numpy(), out["labels"][i])
            points += lab.shape[0]
    mets = np.array([ref.matched_metrics(batch["labels"][i].astype(np.int64),
                                         batch["prim"][i], out["labels"][i],
                                         out["types"][i], batch["points"][i], device)
                     for i in range(x.shape[0])], np.float64)
    gap = np.where(np.isnan(mets) & np.isnan(out["metrics"]), 0.0,
                   np.abs(mets - out["metrics"]))
    info = {"ms_steps": steps, "retried": retried,
            "label_mismatch": mism / points if points else 0.0}
    if diagnose:
        info["shift_quantiles"] = q.T.tolist()
        info["eig_product"], info["eig_direct"] = product, direct
        info.update(affinity_witness(batch, cfg, out["ritz"], device, product))
    return {
        "type_lp_err": _rel(out["type_lp"], f["type_lp"]),
        "embedding_err": _rel(out["embedding"], f["embedding"]),
        "edge_err": _rel(out["edge_prob"], torch.softmax(f["edge_logits"], -1)),
        "eig_err": max(min(g) for g in zip(product, direct)),
        "enriched_err": _rel(x, enriched),
        "bandwidth_err": float(np.max(np.abs(bw_out - np.array(bw)) / np.array(bw))),
        "shift_err": float(q[0].max()),
        "shift_p99_err": float(q[1].max()),
        "metrics_gap": float(np.nanmax(gap)) if gap.size else 0.0,
    }, info


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, control: str | None = None,
        capture_hook=None, cluster_hook=None, diagnose: bool = False) -> dict:
    """One run of an eval cell. control: a precision of `reference.Prec`;
    the reference at that precision then takes the program's place in the
    comparison (the control of `correct`). capture_hook(cap, j, results)
    sees each completed batch's results and cluster_hook(pending) each
    batch's clustering as it is launched, before its NMS (the faults of
    `faults.py`); diagnose: the comparison's witnesses go into the info."""
    import torch
    from sednet_tpu_torch import predict

    dev = torch.device(device)
    cfg = port_config(config, traffic)
    ckpt = ROOT / config["weights"]["file"]
    if sha256(ckpt) != config["weights"]["sha256"]:
        raise SystemExit(f"portbench: {ckpt} differs from the digest in the "
                         "configuration")
    models = predict.load_models(str(ckpt), cfg, dev)
    pool = gen.make_pool(seed, traffic["pool"], traffic["points"],
                         traffic["segments"])
    cap = Capture(seed, cluster_hook)
    tta_fn = cap.type_fn(predict.make_tta_type_log_prob(models["type"], cfg,
                                                        False, False))
    forward_fn = cap.inst_fn(predict.make_forward(models["inst"],
                                                  fused=cfg.fused_encoder))
    stream_seed = gen.derived_seed(seed, 4)

    def stream(batches):
        return predict.predict_shapes_stream(
            models["type"], models["inst"], cap.feed(batches), cfg,
            seed=stream_seed, tta_fn=tta_fn, forward_fn=forward_fn)

    cuda = dev.type == "cuda"
    width = cfg.embed + cfg.spectral_eigvecs
    with cap.hooks(predict):
        warm = gen.eval_batches(gen.derived_seed(seed, 5), pool, traffic["batch"])
        for _ in islice(stream(warm), traffic["warm"]):
            pass
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cap.reset()
        setup_s = time.time() - t_start
        done, batches = 0, 0
        with profiled(trace) as prof:
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                it = stream(gen.eval_batches(seed, pool, traffic["batch"]))
                for j, results in enumerate(it):
                    done += len(results)
                    batches += 1
                    if capture_hook is not None:
                        capture_hook(cap, j, results)
                    cap.complete(j, results)
                    if time.perf_counter() - t0 >= seconds:
                        break
                t1 = time.perf_counter()
            it.close()
        if cuda:
            torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    pulled = cap.pulled + 1
    rec = cap.kept
    del models, it
    cap.live.clear()
    if cuda:
        torch.cuda.empty_cache()

    weights = load_weights(ckpt, dev)
    out = (produced(rec, width) if control is None else
           control_outputs(rec, weights, cfg, dev, ref.Prec(control)))
    checks, info = compare(out, rec["batch"], weights, cfg, dev, diagnose)
    info["lobpcg_iterations"] = [int(i) for _, _, i in rec["ritz"]]
    info["clusters"] = [r["num_clusters"] for r in rec["results"]]
    window = t1 - t0
    steps = info["ms_steps"]
    n, b = traffic["points"], traffic["batch"]
    samples = min(cfg.ms_num_samples, n)
    per_cloud_shift = counts.cluster_work(n, width, steps, samples, cfg.ms_bf16)
    shift_rf = sum(counts.roofline_s(f, by, p)
                   for name, f, by, p in per_cloud_shift if name != "nms")
    nms_rf = sum(counts.roofline_s(f, by, p)
                 for name, f, by, p in per_cloud_shift if name == "nms")
    ctx = {"trace": prof["trace"], "window_s": window, "batches": batches,
           "pulled": pulled, "peak_bytes": peak,
           "peak_flops": counts.PEAK[config["mfu_peak"]],
           "batch_flops": counts.eval_batch_flops(
               b, n, cfg.knn, width, steps, samples, cfg.embed,
               cfg.num_primitives),
           "cluster_roofline_s": b * (pulled * shift_rf + batches * nms_rf)}
    return {"attempted": done, "failed": 0,
            "end_to_end": {"eval_shapes_per_s": done / window,
                           "setup_s": setup_s},
            "checks": checks, "peak_bytes": peak, "ctx": ctx, "info": info}
