"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

(--parent DIR: an older checkout, e.g. unpacked with `git archive` into
build/parent, whose K6b and bf16 mean-shift step are timed beside this
tree's on the same inputs, as far as its C interfaces allow.)

Phases, each printing one JSON line (any failure raises, so the exit code
is not 0):

  build      builds the CUDA kernels of `sednet_tpu_torch/csrc/` with nvcc
             for sm_90a and prints the card's name and power limit;
  kernels    holds each kernel of the headline against its plain PyTorch
             version on the card at the headline shapes, and times kernel,
             plain version, one library call, and the bound the card sets;
  headline   the port's main path: 8 eval clouds of 10000 points through
             the trained `inst` weights of `checkpoints/bench_10k.npz`
             (`segment_batch`: forward, then guarded mean-shift per shape),
             with every kernel's launch count from one run, shapes/s, and
             inst/type IoU held against the JAX package's numbers;
  cluster_batch  the batched clustering path (kernel K2b) on the same
             embeddings, held against the per-shape path;
  kernels_slice2  the same for the kernel cases of the reference-default
             eval: K1 as the spectral affinity (50 farthest on xyz) and
             the bandwidth (k = 128 on the enriched subsample) call it,
             batched and for one shape,
             K2b and K3 on the 140-d HPNet-enriched embeddings of the
             headline batch, K4 at the encoder's three layer shapes (with
             the time of the index route it replaces, K1 plus K6, and
             equal to it bit for bit on every row without a tie);
  predict    the reference-default eval (`predict_shapes`, `bench.py:327`'s
             config: both models, HPNet spectral enrichment, `cluster_batch`
             at E = 140, chamfer-recall metrics) on the same 8 clouds, with
             shapes/s, launches, peak memory, and inst/type IoU and recall
             held against the JAX package's numbers, and one run under
             torch.profiler (device busy share, top kernels, and the host
             and device time of each stage range of predict_shapes);
  predict_fused  the same with `fused_encoder=True` (kernel K4), held to the
             same numbers and to the `predict` run's labels, unprofiled;
  predict_fold5drop  the same with the type model's fold5drop votes;
  predict_cli  the predict CLI's loop (`predict.predict_loader`, which
             `run_prediction` runs over an h5 test set read with h5py;
             this phase needs no h5py) over the same 8 clouds, drawn raw
             from the eval stream into the port's array-backed dataset and
             held to
             headline_shapes' clouds, in two double-buffered batches of 4,
             with the txt dumps and postproc (fitted primitives, curves,
             corners, meshes) into build/predict_cli/: its results equal a
             sequential predict_shapes per batch with the same generator,
             its metrics lie within the predict phase's JAX bars, every
             shape's files exist, and its launches are the predict phase's
             per batch and per shape; shapes/s with dumps and postproc off
             and with dumps on, the streamed and sequential walls, postproc
             s a shape, peak memory;
  fit_pipeline  `bench.py`'s record 3 on the port: `segment_batch` on the
             same 8 clouds, `Evaluation.residual_eval_batch` (eval mode, no
             refit) and `p_coverage`: (a) with the true labels and types,
             every segment's type, residual and fitted parameters against
             the JAX package's (`scripts/jax_fit_reference.py`), (b) on the
             port's own labels, residual and p_cover within JAX's spread
             across keys; shapes/s, each stage's host and device ms under
             torch.profiler, peak memory, launches, the batched fit and its
             SVD alone;
  fit_splines  open and closed B-spline patch clouds through
             `fit_one_shape(eval_mode=True)` and SplineNet at full width
             (seeded `init_like_flax` weights) on the card and on the CPU:
             K1 four times a segment, each graph's neighbour sets against
             `topk_plain` and against the CPU's, control grids, surfaces
             and residuals held where the sets agree; one SplineNet
             forward at 1500 and 1800 points, one refit, and K1 at
             B = 1, k = 10, D = 3 / 64 / 128 against `topk_plain`;
  checkpoints  both models of checkpoints/bench_10k.npz written in the
             reference's `.pth` layout (`utils.torch_import`: plain, with
             `module.`, under "state_dict") into build/checkpoints_smoke/,
             each read by `weights.load_checkpoint` and run on the 8
             headline clouds: bit-equal to the `.npz` model's forward,
             with its launches; each load's seconds (the orbax read is
             skipped, with the reason printed: no orbax writer without JAX,
             and no tensorstore beside the card);
  splinenet_train  SplineNet's supervised trainer at full width (grid 20,
             k 10, 700 points, batch 4), open and closed, on 40 patches of
             `make_spline_patches` (no h5py needed): step 1 on the card
             against the CPU with the card's K1 graphs replayed (metrics,
             gradients, the parameters after Adam, running statistics),
             20 steps of `train_spline_arrays` and the test tenth's
             evaluate into build/splinenet_train/ (K1 4 a forward), a
             step's median ms, its K1 share from one profiled step, peak
             memory, the loss at steps 1 and 20; chamfer's backward on the
             card against the CPU at (4, 900, 3) x (4, 700, 3); K1 at the
             four graph shapes against `topk_plain`;
  kernels_slice3  K6 (the gather-reduce of the index-route edge conv) at
             the encoder's three layer shapes on the real tables and graphs,
             along the Morton order of the points and along the identity
             (the same bits; both timed, with each order's distinct-row
             fraction, the order's own time and three F.embedding_bag
             calls as a yardstick), and K5 (the sorted segment sum of the
             matrix-free A^T v) on the farthest-50 graph of a 32768-point
             cloud at m = 12 and 36 and on as many entries at one
             destination, each against its plain version (K5 also against
             index_add_, bit-identical across two launches, 0 at empty
             destinations);
  spectral_matfree  the matrix-free LOBPCG (`spectral_eigvecs_matfree`) in
             each of its five A^T v layouts on 2 clouds of 32768 points:
             seconds and K5 launches per solve, each layout's matvec against
             the scatter layout's, unit rows; then the "pallas" (K5)
             enrichment through `cluster_batch` and the metrics, held to the
             JAX package's numbers on those clouds, and K2b on those
             enriched embeddings (with SDPA's time);
  predict_bigcloud  `predict_shapes` on the same 2 clouds under bench.py's
             config at N = 32768, where the auto policy takes the
             matrix-free solver: shapes/s, stage times, launches, peak
             memory (below the 4 GiB of one dense 32768^2 affinity), metrics
             held to the JAX package's numbers;
  train      the trainer's loop (`train.train_loader`, which `train.train`
             runs over h5 sets read with h5py; this phase needs no h5py)
             under the production config (configs/config_SEDNet_normal.yml:
             4 x 10000 points, k 64, embed 128, AdamW), the inst model of
             checkpoints/bench_10k.npz preloaded, for 8 steps and one eval
             over synthetic clouds (a ParseNet set and an edge set, mixed)
             in the port's array-backed datasets, checkpoints into
             build/train_smoke/: every step's loss finite, the launches
             (K1, K6 three a forward, K6b three a backward), K6b within its
             rounding bound of its plain version at the three layer shapes
             on the batch's real graphs, the same bits on three launches,
             and the CPU plain version's bits on the first cloud (the
             in-degree's max and 99th percentile beside them; timed beside
             its bound, the plain version and index_add_, its device time
             split into the transpose, pass 1 and pass 2, and, with
             `--parent DIR`, the parent tree's K6b on the same inputs),
             the card's step against
             the CPU's float64 step on one cloud with the same draws, the
             card's graphs and its maxima (each max the CPU would pick
             otherwise a near-tie), the
             gradient leaves whose bits differ between two identical steps
             (recorded), the checkpoint re-read giving the same forward; ms
             a step, shapes/s, peak memory;
  serve      both models exported (`export.export_serving_bundle`) at
             8 x 10000 x 6 under bench.py's config 2 into
             build/serve_smoke/bundle, served by `python -m
             sednet_tpu_torch.serve <bundle> --cluster` in a process of its
             own, four requests (8 clouds as JSON, 3 as npz with one of
             7000 points, /health, a malformed body): status codes, types
             and edges against `predict.forward`'s argmax, instance labels
             against the port's own clustering of the bundle's embedding
             with the server's generators, K1/K2/K3/K6 launched in the
             server; export s, start-up s, bundle MB, each request's ms,
             the busy share of one clustered request;
  parsenet_e2e  the end-to-end trainer (`parsenet_e2e.e2e_train_batch`)
             under the production config from the bench inst model, 3
             steps on 4 synthetic 10000-point clouds: finite losses, a fit
             term above 0 with matched segments, each step's launches (K1,
             K2, K3, K6, K6b), step 1 against the CPU on the card's graphs;
             step ms, phase A / B / C ms, peak memory;
  ms_bf16    the bf16 branch of K2/K2b (`config.ms_bf16`): the predict
             phase's eval with ms_bf16 off and on (K2b bf16, then K3) on
             the same inputs, both held to the JAX package's bars, shapes/s
             of each and the share of labels that change; K2 bf16 at
             (10000, 128) and K2b bf16 at (8, 10000, 128) and (8, 10000,
             140 at 144) against the plain bf16 version by the float64
             rule and on three launches (the same bits), timed beside
             attention in bf16, their bound and, with --parent DIR, the
             parent tree's bf16 kernel, with the achieved TFLOP/s; the
             serve phase's bundle with ms_bf16 set answering one clustered
             request (K2 bf16) with the labels of the port's own
             clustering;
  pointnet2_iou  on the 8 eval clouds: `three_nn` on K1 at k = 3 against
             the plain top-k, `miou_loss_edge` on the card against the CPU,
             FPS to 1024 samples and `ball_query` equal to the CPU's,
             `three_interpolate` and its gradient within 1e-5 of the CPU's;
  resplit    `resplit_instances` on the headline's 8 instance maps on
             the card (the bandwidth, K2 at E = 12 padded, K3), every K2
             step and K3 call held to its plain version at the path's
             inputs: at quantile 0.5 the CPU's partitions with the same
             subsample draws; at 0.1 with two instances merged a cloud,
             where they split, beside the CPU's and a run on float64 steps;
  tools      `gen_vis` over the predict CLI's dumps, and `data.native`
             built with g++ here, its writer byte for byte np.savetxt's.

The line before the last is the `kernels` summary, the last line the
device record. `--parent DIR` (an older checkout, e.g. unpacked with
`git archive` into build/parent) adds that tree's kernels on the same
inputs where its C interfaces match (`parent_parts`): its atomic K6b to
`train`, its bf16 mean-shift step to `ms_bf16`; a tree with neither is
refused.
Without a CUDA device, or outside a checkout of the repo, it exits with
an error and prints no result. nvcc's full register report is in
`build.log` beside the built library.
"""
import importlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()

# Per-shape matched IoU of the JAX package's headline pipeline on the same 8
# eval shapes and checkpoint, run on the CPU:
#   JAX_PLATFORMS=cpu python scripts/jax_headline_reference.py
REF_INST_IOU = [0.9104403419368645, 0.9029878112073358, 0.8623391918828099,
                0.8843708300624379, 0.9915031945704498, 0.9615274519939141,
                0.9253762065927553, 0.6680413992171479]
REF_TYPE_IOU = [1.0] * 8
IOU_TOL = 0.03  # bandwidth subsamples come from different RNGs

# Per-shape usecd metrics of the JAX package's reference-default eval
# (`predict_shapes` under bench.py:327's config) on the same 8 clouds, shape
# i under fold_in(PRNGKey(key), i), on the CPU:
#   JAX_PLATFORMS=cpu python scripts/jax_predict_reference.py
REF_PREDICT = {
    "key7": {
        "inst_iou": [0.9117510484060687, 0.9121914926798697,
                     0.9744203268616474, 0.8975523546892954,
                     0.9952038863374334, 0.9629126849294672,
                     0.9846534178290406, 0.9000300029952001],
        "type_iou": [1.0] * 8,
        "inst_recall": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.8333333333333334],
    },
    "key8": {
        "inst_iou": [0.9117510484060688, 0.9034880112873648,
                     0.9748202468776418, 0.8898570170758298,
                     0.9937041862774544, 0.962905267276823,
                     0.9253767434782184, 0.6675414991971548],
        "type_iou": [1.0] * 8,
        "inst_recall": [1.0] * 8,
    },
    "key9": {
        "inst_iou": [0.9117510484060687, 0.904388371431417,
                     0.9752201668936363, 0.8960565486058124,
                     0.9939041462854515, 0.9630624703060403,
                     0.9252773003596827, 0.6680413992171479],
        "type_iou": [1.0] * 8,
        "inst_recall": [1.0] * 8,
    },
}
REF_PREDICT_FOLD5 = {
    "inst_iou": [0.9117510484060687, 0.9121914926798697, 0.9744203268616474,
                 0.8975523546892954, 0.9952038863374334, 0.9629126849294672,
                 0.9846534178290406, 0.9000300029952001],
    "type_iou": [1.0] * 8,
    "inst_recall": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.8333333333333334],
}


# The same for 2 clouds of 32768 points (`headline_shapes(2, 32768)`), where
# the auto policy takes the matrix-free solver:
#   JAX_PLATFORMS=cpu python scripts/jax_predict_reference.py --points 32768 \
#       --shapes 2 --keys 7 8 9 --fold5drop-keys
REF_PREDICT_BIG = {
    "key7": {"inst_iou": [0.9821013912732003, 0.9386142681244404],
             "type_iou": [0.5, 0.8333333333333334],
             "inst_recall": [1.0, 1.0]},
    "key8": {"inst_iou": [0.982449278561147, 0.9385843244186073],
             "type_iou": [0.5, 0.8333333333333334],
             "inst_recall": [1.0, 1.0]},
    "key9": {"inst_iou": [0.9818696569889881, 0.9402568988392814],
             "type_iou": [0.5, 0.8333333333333334],
             "inst_recall": [1.0, 1.0]},
}


def _ref_means(runs):
    return {m: [float(sum(r[m]) / len(r[m])) for r in runs]
            for m in ("inst_iou", "type_iou", "inst_recall")}


# The port draws its LOBPCG start blocks and subsamples from torch, so it is
# held to the mean over JAX's three keys, within JAX's own spread across
# them (max - min of the per-key batch means), and at least 0.03
_KEY_MEANS = _ref_means(REF_PREDICT.values())
REF_PREDICT_MEAN = {m: sum(v) / len(v) for m, v in _KEY_MEANS.items()}
PREDICT_TOL = {m: max(0.03, max(v) - min(v)) for m, v in _KEY_MEANS.items()}
_KEY_MEANS_BIG = _ref_means(REF_PREDICT_BIG.values())
REF_BIG_MEAN = {m: sum(v) / len(v) for m, v in _KEY_MEANS_BIG.items()}
BIG_TOL = {m: max(0.03, max(v) - min(v)) for m, v in _KEY_MEANS_BIG.items()}
# K1 may swap neighbours only inside a near-tie, at the distance of the one
# it replaced, and in at most this share of the rows
MAX_SWAPPED = 0.01

PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3

BATCH, N_POINTS, K = 8, 10000, 64
HEADLINE_REPS = 3   # timed headline batches (their spread is about 1%)
BIG_BATCH, BIG_POINTS = 2, 32768   # the matrix-free eval's clouds
DEVICE = "cuda"
PARENT_TREE = None  # --parent DIR: an older checkout whose K6b (`train`)
#                     and bf16 mean-shift step (`ms_bf16`) the smoke times
BIG_MEM_GIB = 4.0   # one dense 32768 x 32768 float32 affinity


def emit(rec):
    if "phase" in rec:   # seconds since the smoke started, per phase
        rec = {**rec, "at_s": time.time() - T_START}
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


def split_bound(dot_flops, f32_flops, nbytes):
    """The bound of K1 and K4 at D > 8 and of K2/K2b/K3, whose dot products
    run on the tensor cores by the three-term TF32 split: the larger of three TF32 products for
    each f32 one (3 x dot_flops over the dense TF32 peak) and the bytes
    over the memory rate; beside it, as `bound_f32_ms`, the bound of the
    same work on the f32 CUDA cores (f32_flops over 67 TFLOP/s), the bound
    these kernels were measured against before."""
    t_ops, t_bytes = 3 * dot_flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_f32_ms": bound_ms(f32_flops, nbytes)[0]}


def f64_errors(name, got, plain, exact, exact_plain=None):
    """The kernel's and the float32 plain version's max error against the
    same function in float64 (-inf entries equal in all three count 0);
    exact_plain, where given, is the plain version's own float64 reference
    (K1: the distances to the neighbours it returned). Raises unless the
    kernel errs at most twice as much as the plain version, the sign that
    the split keeps float32 accuracy."""
    def err(t, ref):
        return float((t.double() - ref).abs().nan_to_num(0.0).max())

    out = {"f64_err": err(got, exact),
           "plain_f64_err": err(plain, exact if exact_plain is None
                                else exact_plain)}
    if out["f64_err"] > 2.0 * out["plain_f64_err"]:
        raise AssertionError(f"{name}: float64 error {out} above twice the "
                             "plain version's")
    return out


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


def burst_ms(fn, calls=20):
    """Device time of one call: `calls` calls back to back between two CUDA
    events, after one call of warm-up, so that the host's time per call
    hides behind the device's (time_ms includes it)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def kernel_ms(fn, calls=10):
    """The summed device time of the kernels of one call of fn (torch's
    own kernels, which the profiler sees), over `calls` calls under
    torch.profiler: what a call costs the device when its host time
    overlaps other work, as the Morton order's does in the forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(float(ev.self_device_time_total) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / calls


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


def k1_headline_cases(model, x, emb):
    """K1's cases on the headline path, as (name, q, p, k, keyword
    arguments of `check_topk`): the encoder's three graphs and the
    bandwidth on shape 0's subsample of the embedding."""
    import torch
    from sednet_tpu_torch.predict import HEADLINE

    x1, x2 = _knn_inputs(model, x)
    gen = torch.Generator().manual_seed(0)
    sel = torch.randperm(N_POINTS, generator=gen)[:HEADLINE.ms_num_samples]
    xs = emb[0][sel.to(emb.device)].contiguous()
    return [("knn layer 1 (points_normals)", x, x, K,
             {"metric": "points_normals", "library": False}),
            ("knn layer 2", x1, x1, K, {}),
            ("knn layer 3", x2, x2, K, {}),
            ("bandwidth", xs, xs, 128, {})]


def eval_subsamples(models, x):
    """The eval's enriched embeddings and each shape's bandwidth
    subsample (row indices), as `cluster_batch` draws them."""
    import torch
    from sednet_tpu_torch.predict import HEADLINE

    emb_e = enriched_embeddings(models, x, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(0)
    return emb_e, [torch.randperm(N_POINTS, generator=gen)[
        :HEADLINE.ms_num_samples] for _ in range(BATCH)]


def k1_eval_cases(x, emb_e, sels):
    """K1's cases on the eval path, as `k1_headline_cases` gives them: the
    spectral affinity's 50 farthest on xyz and the bandwidth (k = 128 on
    the subsamples of the enriched embeddings emb_e, padded as
    `cluster_batch` pads them), batched and for one shape as
    `normal_affinity_topk` and `cluster_batch` call them."""
    import torch
    from sednet_tpu_torch.ops.cuda_kernels import kernel_width

    emb_p = kernel_width(emb_e)
    xs = torch.stack([emb_p[i][sels[i].to(emb_p.device)]
                      for i in range(BATCH)]).contiguous()
    xyz = x[..., :3].contiguous()
    far = predict_cfg().spectral_knn
    wide = f"E={emb_e.shape[-1]} at {emb_p.shape[-1]}"
    return [(f"spectral {far} farthest ({BATCH} shapes)", xyz, xyz, far,
             {"largest": True}),
            (f"bandwidth {wide} ({BATCH} shapes)", xs, xs, 128, {}),
            (f"bandwidth {wide}, one shape", xs[0], xs[0], 128, {}),
            (f"spectral {far} farthest, one shape", xyz[0], xyz[0], far,
             {"largest": True})]


def check_topk(name, q, p, k, metric="sqdist", library=True, largest=False,
               max_swapped=MAX_SWAPPED):
    """K1 against topk_plain, by `compare_with_plain`: distances, returned
    and to the returned neighbours, within 1e-5 of the rounding scale
    1 + max |q|^2; neighbour sets equal except where the plain k-th and
    (k+1)-th distances lie within 1e-6 of it, and then in at most
    max_swapped of the rows (None: any share of the near-tie rows).
    largest=True: the k farthest. At D > 8 (the
    tensor-core tile) the bound is the split's and the returned distances
    must err, against float64 distances to the same neighbours, at most
    twice as much as the plain version's."""
    import torch
    from sednet_tpu_torch.ops.flash_topk import (_dist_at, compare_with_plain,
                                                 flash_topk, topk_plain)

    kw = {"metric": metric, "largest": largest}
    idx, dist = flash_topk(q, p, k, return_distances=True, **kw)
    torch.cuda.synchronize()
    cmp = compare_with_plain(q, p, k, idx, dist, **kw)
    if (cmp["bad_rows"] or max(cmp["max_abs_err"], cmp["nbr_err"]) > cmp["tol"]
            or (max_swapped is not None
                and cmp["swapped_rows"] > max_swapped * cmp["rows"])):
        raise AssertionError(f"{name}: {cmp}")
    b = q.shape[0] if q.dim() == 3 else 1
    m, d = q.shape[-2:]
    n = p.shape[-2]
    flops = b * m * n * (2 * 6 + 7 if metric == "points_normals" else 2 * d + 3)
    nbytes = 4 * (q.numel() + p.numel()) + 8 * b * m * k
    bms, by = bound_ms(flops, nbytes)
    bound = {"bound_ms": bms, "bound_by": by}
    if metric == "sqdist" and d > 8:
        bound = split_bound(2 * b * m * n * d, flops, nbytes)
        pdist, pidx = topk_plain(q, p, k, **kw)
        q64, p64 = q.double(), p.double()
        bound.update(f64_errors(
            name, dist, pdist, _dist_at(q64, p64, idx, metric, 1.0),
            _dist_at(q64, p64, pidx, metric, 1.0)))
    rec = {"case": name, "shape": list(q.shape), "k": k, **kw, **cmp,
           "ms": time_ms(lambda: flash_topk(q, p, k, **kw)),
           "plain_ms": time_ms(lambda: topk_plain(q, p, k, **kw),
                               reps=10, warmup=1),
           "library_ms": (time_ms(lambda: torch.topk(
               torch.cdist(q, p), k, largest=largest)) if library else None),
           **bound}
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


def _nonfused_route(geom, a, k, metric, order=None):
    """The index route of the same reductions, as `edge_conv_factored` runs
    it: K1's graph, then K6's gather-reduce over it."""
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.graph import gather_reduce

    return gather_reduce(a, flash_topk(geom, geom, k, metric=metric), order)


def check_fused(name, geom, a, k, metric, order=None):
    """K4 (its phase 2 along `order`, as the fused encoder runs it) against
    fused_edge_reductions_plain by `compare_with_plain`:
    every row outside a near-tie at the k-th distance agrees (same count,
    same maxima, sums within the reassociation bound 1e-5 * k * max|a|),
    and at most MAX_SWAPPED of all rows disagree. Every row whose count is
    k (no column outside its k nearest ties the k-th distance; the others
    are K4's rescanned, tied rows, counted in `tied_rows`) equals the
    index route (K1's graph, then K6) bit for bit. Bound: one distance
    pass, on the tensor cores by the split at D > 8 (`split_bound`, the
    f32 bound as `bound_f32_ms`), else in f32 on the CUDA cores."""
    import torch
    from sednet_tpu_torch.ops import fused_edgeconv as fe

    out = fe.fused_edge_reductions(geom, a, k, metric=metric, order=order)
    torch.cuda.synchronize()
    cmp = fe.compare_with_plain(geom, a, k, out, metric=metric)
    if cmp["bad_rows"] or cmp["swapped_rows"] > MAX_SWAPPED * cmp["rows"]:
        raise AssertionError(f"K4 {name}: {cmp}")
    sm, sq, mx = _nonfused_route(geom, a, k, metric, order)
    untied = out[3] == k
    differ = [w for w, got, want in (("mx", out[0], mx), ("sm", out[1], sm),
                                     ("sq", out[2], sq))
              if not torch.equal(got[untied], want[untied])]
    if differ or int(out[3].min()) < k:
        raise AssertionError(f"K4 {name}: rows without a tie differ from "
                             f"the index route in {differ}")
    b, n, d = geom.shape
    c = a.shape[-1]
    flops = b * n * n * (2 * 6 + 7 if metric == "points_normals" else 2 * d + 3)
    flops += 4 * float(out[3].sum()) * c  # max, sum, square, sum per hit
    nbytes = 4 * (geom.numel() + a.numel() + 3 * b * n * c + b * n)
    if metric == "sqdist" and d > 8:
        bound = split_bound(2 * b * n * n * d, flops, nbytes)
    else:
        bms, by = bound_ms(flops, nbytes)
        bound = {"bound_ms": bms, "bound_by": by}
    return {"case": name, "shape": [b, n, d, c], "k": k, "metric": metric,
            **cmp, "mean_count": float(out[3].mean()),
            "tied_rows": int((~untied).sum()), "index_route_equal": True,
            "ms": time_ms(lambda: fe.fused_edge_reductions(
                geom, a, k, metric=metric, order=order), reps=5),
            "plain_ms": time_ms(lambda: fe.fused_edge_reductions_plain(
                geom, a, k, metric=metric), reps=3, warmup=1),
            "library_ms": None,
            "nonfused_route_ms": time_ms(lambda: _nonfused_route(
                geom, a, k, metric, order), reps=5),
            **bound}


def _fused_layer_inputs(model, x):
    """(name, geom, sign(scale) * a, metric) of the encoder's three edge
    convolutions on the real layer inputs, as `fused_edge_conv` feeds K4."""
    import torch
    import torch.nn.functional as F

    enc = model.encoder
    x1, x2 = _knn_inputs(model, x)
    out = []
    for name, conv, feats, metric in (
            ("layer 1 (points_normals)", enc.conv1, x, "points_normals"),
            ("layer 2", enc.conv2, x1, "sqdist"),
            ("layer 3", enc.conv3, x2, "sqdist")):
        w = conv.conv.weight
        sign = torch.where(conv.gn.weight >= 0, 1.0, -1.0)
        with torch.no_grad():
            a = (F.linear(feats, w[:, :feats.shape[-1]]) * sign).contiguous()
        out.append((name, feats.contiguous(), a, metric))
    return out


def _check_k2b_wide(emb_e, bw, case="enriched"):
    """K2b on the 140-d enriched embeddings, run as `cluster_batch` runs it:
    zero-padded once to 160 (`kernel_width`). Held against the plain
    version at 140, so the zero columns are checked too. Returns the case
    and the kernel's step at 160."""
    import torch
    import torch.nn.functional as F
    from sednet_tpu_torch.ops import cuda_kernels as ck

    b, n, e = emb_e.shape
    emb_p = ck.kernel_width(emb_e)
    inv_b2 = 1.0 / (bw * bw)
    got_p = ck.mean_shift_step_batched(emb_p, emb_p, bw)
    got = got_p[..., :e]
    want = ck.mean_shift_step_plain(emb_e, emb_e, inv_b2)
    exact = ck.mean_shift_step_plain(emb_e.double(), emb_e.double(),
                                     inv_b2.double())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-5 or float(got_p[..., e:].abs().sum()) != 0.0:
        raise AssertionError(f"K2b E={e}: max abs error {err} > 1e-5, or "
                             "padding columns not zero")
    ep = emb_p.shape[-1]
    k2b = {"case": f"{case} E={e}", "shape": [b, n, e],
           "run_width": ep, "max_abs_err": err, "tol": 1e-5,
           **f64_errors(f"K2b E={e}", got, want, exact),
           "ms": time_ms(lambda: ck.mean_shift_step_batched(emb_p, emb_p, bw)),
           "plain_ms": time_ms(lambda: ck.mean_shift_step_plain(
               emb_e, emb_e, inv_b2), reps=3),
           # the yardstick of the E=128 case: attention with q scaled by
           # 1/b^2 is the same normalised kernel-weighted mean
           "library_ms": time_ms(lambda: F.normalize(
               F.scaled_dot_product_attention(
                   (emb_e * inv_b2[:, None, None])[:, None], emb_e[:, None],
                   emb_e[:, None], scale=1.0)[:, 0], dim=-1, eps=1e-12)),
           **split_bound(4 * b * n * n * e, b * n * n * (4 * e + 4),
                         4 * 3 * b * n * e),
           "bound_run_width_ms": 3e3 * 4 * b * n * n * ep / PEAK_TF32_FLOPS}
    return k2b, got_p


def _check_wide(emb_e, bw):
    """K2b (`_check_k2b_wide`) and K3 on the 140-d enriched embeddings, run
    at the padded 160. K3 on real rows: values within 1e-5 of the plain
    version's, and each returned index scores within 1e-5 of the plain
    best."""
    import torch
    from sednet_tpu_torch.ops import cuda_kernels as ck

    k2b, got_p = _check_k2b_wide(emb_e, bw)
    n, e = emb_e.shape[1:]
    emb_p = ck.kernel_width(emb_e)
    ep = emb_p.shape[-1]
    got = got_p[..., :e]
    rows, cols = emb_e[0], got[0].contiguous()
    rows_p, cols_p = emb_p[0], got_p[0]
    zeros = torch.zeros(n, device=rows.device)
    inf = float("inf")
    bk, ik = ck.colmax(rows_p, cols_p, zeros, inf, 1.0)
    bp, ip = ck.colmax_plain(rows, cols, zeros, inf, 1.0)
    b64, _ = ck.colmax_plain(rows.double(), cols.double(), zeros.double(),
                             inf, 1.0)
    torch.cuda.synchronize()
    err = float((bk - bp).abs().max())
    at = (rows * cols[ik.long()]).sum(-1)
    gap = float((bp - at).max())
    if err > 1e-5 or gap > 1e-5:
        raise AssertionError(f"K3 E={e}: value error {err}, index gap {gap}")
    k3 = {"case": f"membership, enriched E={e}", "shape": [n, n, e],
          "run_width": ep, "max_abs_err": err, "tol": 1e-5,
          **f64_errors(f"K3 E={e}", bk, bp, b64),
          "index_score_gap": gap, "indices_differ": int((ik != ip).sum()),
          "ms": time_ms(lambda: ck.colmax(rows_p, cols_p, zeros, inf, 1.0)),
          "plain_ms": time_ms(lambda: ck.colmax_plain(rows, cols, zeros, inf,
                                                      1.0)),
          "library_ms": time_ms(lambda: torch.max(rows @ cols.T, dim=1)),
          **split_bound(2 * n * n * e, n * n * (2 * e + 4),
                        4 * (2 * n * e + 3 * n)),
          "bound_run_width_ms": 3e3 * 2 * n * n * ep / PEAK_TF32_FLOPS}
    return k2b, k3


def phase_kernels(model, x, emb):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.predict import HEADLINE

    out = {"K1": [check_topk(*case[:4], **case[4])
                  for case in k1_headline_cases(model, x, emb)]}

    # K2 / K2b: one step from the embeddings at each shape's bandwidth
    gen = torch.Generator().manual_seed(0)
    ns = HEADLINE.ms_num_samples
    # the draw of the bandwidth case's subsample, so that the steps below
    # take the bandwidths they took when it came from this generator
    torch.randperm(N_POINTS, generator=gen)
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
        e64 = emb[:b].double()
        exact = ck.mean_shift_step_plain(e64, e64, inv_b2[:b].double())
        exact = exact[0] if name == "K2" else exact
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > 1e-5:
            raise AssertionError(f"{name}: max abs error {err} > 1e-5")
        e = emb.shape[-1]
        cases.append({"case": name, "shape": [b, N_POINTS, e],
                      "max_abs_err": err, "tol": 1e-5,
                      **f64_errors(name, got, want, exact),
                      "ms": time_ms(fn), "plain_ms": time_ms(plain),
                      "library_ms": time_ms(lib),
                      **split_bound(4 * b * N_POINTS * N_POINTS * e,
                                    b * N_POINTS * N_POINTS * (4 * e + 4),
                                    4 * 3 * b * N_POINTS * e)})
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
        b64, _ = ck.colmax_plain(rows.double(), cols.double(), bias.double(),
                                 thresh, gain)
        torch.cuda.synchronize()
        err = float((bk - bp).abs().nan_to_num(0.0).max())
        if err > 1e-5 or not torch.equal(ik, ip):
            raise AssertionError(f"K3 {name}: value error {err}, "
                                 f"{int((ik != ip).sum())} indices differ")
        k3.append({"case": name, "shape": [N_POINTS, N_POINTS, 128],
                   "max_abs_err": err, "tol": 1e-5, "indices_equal": True,
                   **f64_errors(f"K3 {name}", bk, bp, b64),
                   "ms": time_ms(lambda: ck.colmax(rows, cols, bias, thresh,
                                                   gain)),
                   "plain_ms": time_ms(lambda: ck.colmax_plain(
                       rows, cols, bias, thresh, gain)),
                   "library_ms": time_ms(lambda: torch.max(
                       torch.addmm(bias, rows, cols.T), dim=1))
                   if gain == 1.0 and thresh == inf else None,
                   **split_bound(2 * N_POINTS * N_POINTS * 128,
                                 N_POINTS * N_POINTS * (2 * 128 + 4),
                                 4 * (2 * N_POINTS * 128 + 3 * N_POINTS))})
    out["K3"] = k3
    emit({"phase": "kernels", "ok": True, "results": out})
    return out


def phase_kernels_slice2(models, x):
    """The kernel cases of the reference-default eval, after the headline
    (so that the headline runs where it ran before them): K1 as the
    spectral affinity (the 50 farthest on xyz) and the bandwidth (k = 128
    on the padded enriched subsample) call it, K2b and K3 on the 140-d
    enriched embeddings, K4 at the encoder's three layers (with the Morton
    order of the points that the fused encoder hands it)."""
    import numpy as np
    import torch
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.ops.graph import locality_order
    from sednet_tpu_torch.predict import HEADLINE

    emb_e, sels = eval_subsamples(models, x)
    ns = HEADLINE.ms_num_samples
    bw_e = torch.stack([torch.clamp_min(compute_bandwidth(
        emb_e[i], ns, np.float32(HEADLINE.ms_quantile), sel=sels[i]), 0.003)
        for i in range(BATCH)])
    k1 = [check_topk(*case[:4], **case[4])
          for case in k1_eval_cases(x, emb_e, sels)]
    k2b_e, k3_e = _check_wide(emb_e, bw_e)
    order = locality_order(x[..., :3].contiguous())  # as the encoder's
    out = {"K1": k1, "K2b": [k2b_e], "K3": [k3_e],
           "K4": [check_fused(name, g, a, K, metric, order)
                  for name, g, a, metric
                  in _fused_layer_inputs(models["inst"], x)]}
    emit({"phase": "kernels_slice2", "ok": True, "results": out})
    return out


def _wrappers():
    """Each kernel's wrapper and the attribute that counts its launches
    (K2 and K2b count their bf16 kernel apart, as "K2 bf16" and "K2b
    bf16")."""
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.fused_edgeconv import fused_edge_reductions
    from sednet_tpu_torch.ops.graph import gather_reduce, gather_reduce_backward

    return {"K1": (flash_topk, "launches"),
            "K2": (ck.mean_shift_step, "launches"),
            "K2b": (ck.mean_shift_step_batched, "launches"),
            "K2 bf16": (ck.mean_shift_step, "launches_bf16"),
            "K2b bf16": (ck.mean_shift_step_batched, "launches_bf16"),
            "K3": (ck.colmax, "launches"),
            "K4": (fused_edge_reductions, "launches"),
            "K5": (ck.segsum_sorted_scan, "launches"),
            "K6": (gather_reduce, "launches"),
            "K6b": (gather_reduce_backward, "launches")}


def reset_counts():
    for fn, attr in _wrappers().values():
        setattr(fn, attr, 0)


def read_counts():
    return {key: getattr(fn, attr) for key, (fn, attr) in _wrappers().items()}


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
    for name in ("K1", "K2", "K3", "K6"):
        if counts[name] <= 0:
            raise AssertionError(f"main path launched {name} no time")
    labels_np, types_np = labels.cpu().numpy(), types.cpu().numpy()
    if labels_np.shape != (BATCH, N_POINTS) or labels_np.min() < 0:
        raise AssertionError(f"bad labels {labels_np.shape}")
    inst, typ, per = batch_iou(shapes, labels_np, types_np)
    ref_inst, ref_type = float(np.mean(REF_INST_IOU)), float(np.mean(REF_TYPE_IOU))
    ok = abs(inst - ref_inst) <= IOU_TOL and abs(typ - ref_type) <= IOU_TOL

    ts, runs = [], []
    for _ in range(HEADLINE_REPS):
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
    peaks = _forward_peaks(lambda v: forward(model, v), x)
    rec = {"phase": "headline", "ok": ok, "shapes_per_s": BATCH / med,
           "batch_s_median": med, "batch_s_min": min(ts),
           "batch_s_max": max(ts),
           "timing": f"median of {HEADLINE_REPS} synced batches",
           "forward_s_median": float(np.median(fw)), **peaks,
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


PREDICT_KW = dict(num_points=N_POINTS, knn=K, embed=128, hpnet_embed=True,
                  ms_num_samples=5000)   # bench.py:327


def predict_cfg(**kw):
    from sednet_tpu_torch.config import Config

    return Config(**PREDICT_KW, **kw)


def enriched_embeddings(models, x, gen):
    """The clustering embedding of `predict_shapes` (B, N, 140), by its
    own `enrich_embedding` on the raw inst embedding of each shape."""
    import torch
    from sednet_tpu_torch.predict import enrich_embedding, make_forward

    cfg = predict_cfg()
    _, emb, _ = make_forward(models["inst"])(x)
    return torch.stack([enrich_embedding(
        emb[i], x[i, :, :3], x[i, :, 3:6], cfg, generator=gen)
        for i in range(x.shape[0])]).contiguous()


def _forward_peak_gib(fwd, x):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd(x)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _forward_peaks(fwd, x):
    """The forward's peak device memory and time through K6, and with the
    edge convolutions' gather-reduce swapped for its plain version (the
    materialised (B, N, K, C) gather the index route had before K6)."""
    import torch
    from sednet_tpu_torch.ops import graph

    def timed():
        torch.cuda.synchronize()
        t0 = time.time()
        fwd(x)
        torch.cuda.synchronize()
        return time.time() - t0

    out = {"forward_peak_gib": _forward_peak_gib(fwd, x),
           "forward_s_k6": min(timed() for _ in range(3))}
    kernel = graph.gather_reduce
    graph.gather_reduce = lambda a, idx, order=None: \
        graph.gather_reduce_plain(a, idx)
    try:
        out["forward_peak_gib_plain_gather"] = _forward_peak_gib(fwd, x)
        out["forward_s_plain_gather"] = min(timed() for _ in range(3))
    finally:
        graph.gather_reduce = kernel
    return out


def _stage_times(trace_path, stages=None):
    """Each stage range (by default predict_shapes', `predict.STAGES`;
    named "a/b", keyed "b") from a chrome trace of one call: its host ms,
    and the device ms of the kernels, copies and fills whose launch (the
    runtime call with the same correlation id) lies inside it. The kernels
    of `csrc/` come through ctypes, outside any torch op, so the
    profiler's own per-op device times miss them; the launch call does
    not."""
    from sednet_tpu_torch.predict import STAGES

    stages = stages or STAGES
    with open(trace_path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X"]
    spans, launch, dev = [], {}, []
    for ev in events:
        cat, corr = ev.get("cat"), ev.get("args", {}).get("correlation")
        if cat == "user_annotation" and ev["name"] in stages:
            spans.append((ev["ts"], ev["ts"] + ev["dur"],
                          ev["name"].split("/")[1]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch[corr] = ev["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((corr, ev["dur"]))
    out = {n.split("/")[1]: {"host_ms": 0.0, "device_ms": 0.0, "ranges": 0}
           for n in stages}
    for t0, t1, name in spans:
        out[name]["host_ms"] += (t1 - t0) / 1e3
        out[name]["ranges"] += 1
    outside = 0.0
    for corr, dur in dev:
        t = launch.get(corr, -1.0)
        hit = next((n for t0, t1, n in spans if t0 <= t <= t1), None)
        if hit is None:
            outside += dur / 1e3
        else:
            out[hit]["device_ms"] += dur / 1e3
    out["outside_stages"] = {"device_ms": outside}
    return out


def _device_profile(run, trace_name="predict_trace.json", stages=None):
    """One run under torch.profiler: the wall time, the summed device time
    of its kernels (the events on the device, not the host ops that
    launched them, which carry the same time again), their share of the
    wall time, the top kernels, and each stage's host and device time
    (`_stage_times` of `stages`, by default predict_shapes'; the trace is
    kept in build/<trace_name>)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sednet_tpu_torch.predict import STAGES

    stages = stages or STAGES

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0

    # the stage ranges also show on the device's timeline: not kernels
    rows = [(ev.key, float(ev.self_device_time_total), ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.key not in stages]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    trace = os.path.join(ROOT, "build", trace_name)
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    return {"wall_s": wall, "device_kernel_s": busy if rows else None,
            "device_busy_share": busy / wall if rows else None,
            "top": [[k[:60], us / 1e3, n] for k, us, n in rows[:10]],
            "stages": _stage_times(trace, stages)}


def phase_predict(name, models, batch, inputs, *, fused=False,
                  fold5drop=False, reps=3, cfg=None, ref=None, tol=None,
                  trace="predict_trace.json", profiled=None):
    """predict_shapes on `batch` under bench.py's config (cfg: that config
    at the batch's cloud size), with the injected random inputs `inputs` =
    (x0s, sels), so that runs compare label for label. Launches, peak
    memory and metrics from the first run (held to ref within tol, by
    default the JAX numbers of the 10k clouds); shapes/s the median of
    `reps` more, each ended by a synchronize; then, on the index route
    without fold5drop (or as `profiled` says), one profiled run."""
    import numpy as np
    import torch
    from sednet_tpu_torch.predict import (make_forward,
                                          make_tta_type_log_prob,
                                          predict_shapes)

    cfg = cfg or predict_cfg(fused_encoder=fused)
    tta = make_tta_type_log_prob(models["type"], cfg, False, fold5drop)
    fwd = make_forward(models["inst"], fused=fused)
    x0s, sels = inputs
    b, n = batch["points"].shape[:2]

    def run():
        return predict_shapes(models["type"], models["inst"], batch, cfg,
                              tta_fn=tta, forward_fn=fwd, x0s=x0s, sels=sels)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # the type model keeps the index route (K6) even with the fused encoder;
    # the direct edge convolution (factored_gn off, model_bf16) runs none
    direct = not cfg.factored_gn or cfg.model_bf16
    need = (("K1", "K2b bf16" if cfg.ms_bf16 else "K2b", "K3")
            + (() if direct else ("K6",)) + (("K4",) if fused else ()))
    for key in need:
        if counts[key] <= 0:
            raise AssertionError(f"{name} launched {key} no time")
    labels = np.stack([r["cluster_ids"] for r in res])
    if labels.shape != (b, n) or labels.min() < 0:
        raise AssertionError(f"{name}: bad labels {labels.shape}")
    got = {m: float(np.mean([r[m] for r in res]))
           for m in ("inst_iou", "type_iou", "inst_recall")}
    if not all(np.isfinite(v) for v in got.values()):
        raise AssertionError(f"{name}: metrics not finite {got}")
    if ref is None:
        ref, tol = dict(REF_PREDICT_MEAN), PREDICT_TOL
        if fold5drop:  # the votes change types only (JAX: same inst numbers)
            ref["type_iou"] = float(np.mean(REF_PREDICT_FOLD5["type_iou"]))
    ok = all(abs(got[m] - ref[m]) <= tol[m] for m in got)
    ts = []
    for _ in range(reps):
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        ts.append(time.time() - t0)
    med = float(np.median(ts))
    # one profiled run of the index route (the fused route's stages read
    # the same but for inst_forward; a profile costs 12-30 s of tracing)
    if profiled is None:
        profiled = not (fused or fold5drop)
    if profiled:
        profile = _device_profile(run, trace)
    x = torch.from_numpy(np.concatenate([batch["points"], batch["normals"]],
                                        -1)).to(DEVICE)
    rec = {"phase": name, "ok": ok, "shapes_per_s": b / med,
           "batch_s_median": med, "batch_s_min": min(ts),
           "batch_s_max": max(ts), "timing": f"median of {reps} synced batches",
           **got, "ref": ref, "tol": tol,
           "per_shape": [[r["inst_iou"], r["type_iou"], r["inst_recall"],
                          r["num_clusters"]] for r in res],
           "guard_capped": sum(r["guard_capped"] for r in res),
           "launches": counts, "peak_mem_gib": peak_gib,
           **({"profile": profile} if profiled else {}),
           **(_forward_peaks(fwd, x) if not fused else
              {"forward_peak_gib": _forward_peak_gib(fwd, x)})}
    return rec, labels, fwd


def phase_predict_all(models, shapes):
    """The predict, predict_fused and predict_fold5drop phases."""
    import numpy as np
    import torch

    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    gen = torch.Generator().manual_seed(3)
    x0s = [torch.randn((N_POINTS, 12), generator=gen) for _ in range(BATCH)]
    sels = [torch.randperm(N_POINTS, generator=gen)[:5000]
            for _ in range(BATCH)]
    out = {}
    for name, fused, fold5 in (("predict", False, False),
                               ("predict_fused", True, False),
                               ("predict_fold5drop", False, True)):
        rec, labels, fwd = phase_predict(name, models, batch, (x0s, sels),
                                         fused=fused, fold5drop=fold5,
                                         reps=1 if fold5 else 2)
        out[name] = (rec, labels, fwd)
        if fused:
            x = torch.from_numpy(np.concatenate(
                [batch["points"], batch["normals"]], -1)).to(DEVICE)
            e_def = out["predict"][2](x)[1]
            e_fus = fwd(x)[1]
            cos = (torch.nn.functional.normalize(e_def, dim=-1)
                   * torch.nn.functional.normalize(e_fus, dim=-1)).sum(-1)
            aris = [_ari(labels[i], out["predict"][1][i])
                    for i in range(BATCH)]
            rec.update({
                "max_angle_vs_predict_rad": float(torch.arccos(
                    cos.clamp(-1.0, 1.0)).max()),
                "ari_vs_predict": aris,
                "forward_peak_gib_predict": out["predict"][0][
                    "forward_peak_gib"]})
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{name}: metrics out of tolerance {rec}")
    return {name: v[0] for name, v in out.items()}


CLI_BATCH = 4        # the 8 clouds in two batches, so that two overlap
CLI_ITEM_TOL = 1e-6  # the dataset's items against headline_shapes' x
# launches a shape makes on the predict path: its farthest-50 graph and its
# bandwidth (K1), its three NMS passes (K3); the rest are launches a batch
CLI_PER_SHAPE = {"K1": 2, "K2b": 0, "K3": 3, "K6": 0}
CLI_DUMPS = ("inst", "type", "GT_inst", "GT_type", "Vis_type", "Vis_inst",
             "edge", "GT_points")


def cli_dataset():
    """The 8 raw eval clouds, drawn from EVAL_STREAM_SEED as
    headline_shapes draws them, in the port's array-backed dataset (the
    class under ParseNetDataset and EdgeDataset, which read h5 files),
    eval mode."""
    import numpy as np
    from sednet_tpu_torch.data import EVAL_STREAM_SEED, make_synthetic_shape
    from sednet_tpu_torch.data.datasets import _H5Dataset

    rng = np.random.RandomState(EVAL_STREAM_SEED)
    raw = [make_synthetic_shape(rng, n_points=N_POINTS, n_segments=6)
           for _ in range(BATCH)]
    arr = {k: np.stack([d[k] for d in raw]) for k in
           ("points", "labels", "normals", "prim", "edges", "edges_w")}
    return _H5Dataset(arr["points"], arr["labels"], arr["normals"],
                      arr["prim"], arr["edges"], arr["edges_w"], train=False,
                      num_points=N_POINTS)


def _cli_expected_launches(pred_launches, n_batches):
    """The launches of the CLI loop over n_batches batches of the BATCH
    clouds, from those of one predict_shapes call on all of them."""
    return {k: n_batches * (pred_launches[k] - per * BATCH) + per * BATCH
            for k, per in CLI_PER_SHAPE.items()}


def _same_results(got, want):
    """The fields of (a) that differ between two per-shape result lists."""
    import numpy as np

    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("cluster_ids", "pred_primitives", "num_clusters",
                     "guard_capped", "guard_bw_capped", "inst_iou",
                     "type_iou", "inst_recall"):
            if not np.array_equal(g[name], w[name]):
                bad.append((i, name))
    return bad


def phase_predict_cli(models, shapes, pred_launches):
    """The predict CLI's loop (`predict.predict_loader`, which
    run_prediction runs over an h5 dataset) over the 8 clouds in batches of
    CLI_BATCH, under the predict phase's config, with the txt dumps and
    postproc into build/predict_cli/. Held to: (a) a sequential
    predict_shapes per batch with the same generator, field for field;
    (b) the predict phase's JAX bars; (c) every shape's files; (d) the
    predict phase's launches, per batch and per shape. Timed: the loop with
    dumps and postproc off, with dumps on, and a sequential
    predict_shapes per batch, each from a cold spectral cache."""
    import shutil

    import numpy as np
    import torch
    from sednet_tpu_torch import predict
    from sednet_tpu_torch.data import BatchLoader

    cfg = predict_cfg()
    ds = cli_dataset()
    item_err = max(float(np.abs(ds[i][k] - shapes[i][k]).max())
                   for i in range(BATCH) for k in ("points", "normals"))
    labels_same = all(np.array_equal(ds[i][k], shapes[i][k])
                      for i in range(BATCH) for k in ("labels", "prim"))
    if item_err > CLI_ITEM_TOL or not labels_same:
        raise AssertionError(f"predict_cli: dataset items {item_err} from "
                             f"headline_shapes (labels same: {labels_same})")
    root = os.path.join(ROOT, "build", "predict_cli")

    def loop(name, **kw):
        out = os.path.join(root, name)
        shutil.rmtree(out, ignore_errors=True)
        loader = BatchLoader(ds, CLI_BATCH, shuffle=False, drop_last=False)
        torch.cuda.synchronize()
        t0 = time.time()
        summary, res = predict.predict_loader(
            loader, cfg, models["type"], models["inst"], out_dir=out, **kw)
        torch.cuda.synchronize()
        return time.time() - t0, summary, res, out

    # the checked run, with dumps and postproc; postproc timed in place
    post_s = []
    run_postproc = predict.run_postproc

    def timed_postproc(*args):
        t0 = time.time()
        out = run_postproc(*args)
        post_s.append(time.time() - t0)
        return out

    predict.run_postproc = timed_postproc
    reset_counts()
    try:
        wall_full, summary, res, out = loop("full", save_viz=True,
                                            postproc=True)
    finally:
        predict.run_postproc = run_postproc
    counts = read_counts()
    n_batches = -(-BATCH // CLI_BATCH)
    expected = _cli_expected_launches(pred_launches, n_batches)
    launches_ok = all(counts[k] == v for k, v in expected.items())

    # (a): each batch through predict_shapes alone, its generator the same
    batches = list(BatchLoader(ds, CLI_BATCH, shuffle=False,
                               drop_last=False))
    tta = predict.make_tta_type_log_prob(models["type"], cfg, False, False)
    fwd = predict.make_forward(models["inst"])
    torch.cuda.synchronize()
    t0 = time.time()
    seq = [r for b in batches for r in predict.predict_shapes(
        models["type"], models["inst"], b, cfg, tta_fn=tta, forward_fn=fwd,
        generator=predict.batch_generator(cfg.seed))]
    torch.cuda.synchronize()
    wall_seq = time.time() - t0
    differ = _same_results(res, seq)

    torch.cuda.reset_peak_memory_stats()
    wall_stream, _, res_b, _ = loop("nodumps", save_viz=False,
                                    postproc=False)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    wall_dumps, _, _, _ = loop("dumps", save_viz=True, postproc=False)
    differ += [("nodumps",) + d for d in _same_results(res_b, seq)]

    got = {m: summary[m] for m in ("inst_iou", "type_iou", "inst_recall")}
    bars_ok = all(abs(got[m] - REF_PREDICT_MEAN[m]) <= PREDICT_TOL[m]
                  for m in got)
    missing = [p for sid in range(BATCH) for p in
               [f"{sid}_{d}.txt" for d in CLI_DUMPS]
               + [os.path.join("paras", f"param_{sid}.txt"),
                  os.path.join("paras", f"param_inter_lines_{sid}.json"),
                  f"{sid}_mesh"]
               if not os.path.exists(os.path.join(out, p))]
    ok = (not differ and bars_ok and not missing and launches_ok
          and summary["n_shapes"] == BATCH)
    emit({"phase": "predict_cli", "ok": ok, "batch": CLI_BATCH,
          "n_batches": n_batches, "n_shapes": summary["n_shapes"],
          "item_max_abs_err": item_err, "item_tol": CLI_ITEM_TOL,
          "shapes_per_s_no_dumps": BATCH / wall_stream,
          "shapes_per_s_dumps": BATCH / wall_dumps,
          "wall_streamed_s": wall_stream, "wall_sequential_s": wall_seq,
          "wall_dumps_postproc_s": wall_full,
          "postproc_s_per_shape": float(np.mean(post_s)),
          "postproc_s": post_s, "peak_mem_gib": peak_gib,
          **got, "ref": REF_PREDICT_MEAN, "tol": PREDICT_TOL,
          "per_shape": [[r["inst_iou"], r["type_iou"], r["inst_recall"],
                         r["num_clusters"]] for r in res],
          "guard_capped": summary["guard_capped"],
          "launches": counts, "expected_launches": expected,
          "differ_from_sequential": differ, "missing_files": missing})
    if not ok:
        raise AssertionError(
            f"predict_cli: differ {differ}, bars {got}, missing {missing}, "
            f"launches {counts} (expected {expected})")
    return counts


# The JAX package's fit pipeline (`bench.py` record 3) on the same 8 clouds,
# on the CPU: `Evaluation.residual_eval_batch` (eval mode, no refit) and
# `p_coverage`, with the true labels and types (REF_FIT_GT) and after the
# headline pipeline under keys 7, 8 and 9 (REF_FIT_KEYS):
#   JAX_PLATFORMS=cpu python scripts/jax_fit_reference.py
REF_FIT_GT = (
    {'segments': [{'0': ['sphere', 0.0031622787937521935,
                         [-0.02894206, 0.07717465, 0.17231283, 0.10169462]],
                   '1': ['cone', 0.0031622787937521935,
                         [-0.07142353, -0.13750322, 0.08699946, 0.3195388,
                          -0.81091422, -0.49021724, 0.4767597]],
                   '2': ['sphere', 0.0031622787937521935,
                         [-0.07690947, -0.05910506, 0.02271463, 0.26930442]],
                   '3': ['cylinder', 0.0031622787937521935,
                         [0.96736485, 0.21963628, 0.12635323, -0.05210274,
                          0.15142939, 0.135675, 0.13254559]],
                   '4': ['cone', 0.0031622787937521935,
                         [-0.09727754, 0.19222474, -0.06608868, 0.63896155,
                          -0.30938858, -0.70427746, 0.77718037]],
                   '5': ['cylinder', 0.0031622787937521935,
                         [-0.40454674, -0.41748285, 0.81366456, -0.00376939,
                          0.00700105, 0.00171806, 0.15707304]]},
                  {'0': ['sphere', 0.0031622787937521935,
                         [0.02077555, 0.06649236, 0.11027005, 0.12541665]],
                   '1': ['cone', 0.0031622787937521935,
                         [0.05986045, -0.18971793, -0.16161919, -0.34339491,
                          0.03381877, -0.93858212, 0.71842104]],
                   '2': ['plane', 0.0031622787937521935,
                         [0.08674083, 0.99560606, -0.03527949, 0.01372906]],
                   '3': ['cone', 0.0031622787937521935,
                         [0.0927892, 0.05163581, 0.20938601, -0.54639679,
                          -0.70455825, 0.45282224, 0.64793223]],
                   '4': ['sphere', 0.0031622787937521935,
                         [0.03006885, 0.09069792, -0.09003825, 0.11454123]],
                   '5': ['cone', 0.0031622787937521935,
                         [0.18505758, 0.0377964, 0.05766876, -0.99674582,
                          0.01964696, -0.07817777, 0.87639046]]},
                  {'0': ['cone', 0.0031622787937521935,
                         [0.19561017, -0.07541045, -0.14106749, -0.71800888,
                          -0.64559692, -0.26013038, 0.32892209]],
                   '1': ['cone', 0.0031622787937521935,
                         [0.12635715, 0.11556537, 0.26420444, -0.75937146,
                          0.57730788, -0.30011749, 0.86725372]],
                   '2': ['cylinder', 0.0031622787937521935,
                         [-0.01945804, 0.27459621, 0.96136278, -0.10927684,
                          -0.03535864, 0.0078878, 0.19438639]],
                   '3': ['plane', 0.0031622787937521935,
                         [-0.07222927, 0.46952587, 0.87995934, -0.12699009]],
                   '4': ['sphere', 0.0031622787937521935,
                         [0.03362903, 0.43555865, -0.13926615, 0.23711622]],
                   '5': ['cylinder', 0.0031622787937521935,
                         [0.97915494, 0.17385492, -0.1050241, 0.06032476,
                          -0.17924741, 0.26569375, 0.09988147]]},
                  {'0': ['cone', 0.0031622787937521935,
                         [0.07370789, -0.05604468, -0.26815304, -0.45459375,
                          -0.47672257, -0.75238305, 0.37942258]],
                   '1': ['cylinder', 0.0031622787937521935,
                         [0.67197543, -0.39058679, 0.62919873, 0.097628,
                          0.21424794, 0.02873305, 0.1607088]],
                   '2': ['cone', 0.0031622787937521935,
                         [0.22028394, -0.19486739, -0.10853441, -0.72444671,
                          0.54889882, 0.41699779, 0.28183573]],
                   '3': ['cylinder', 0.0031622787937521935,
                         [-0.41564086, 0.46452171, 0.78196061, -0.06240603,
                          -0.20580481, 0.08908672, 0.16068208]],
                   '4': ['plane', 0.0031622787937521935,
                         [0.92095762, 0.22982925, 0.31466737, 0.00677742]],
                   '5': ['cone', 0.0031622787937521935,
                         [0.20804538, 0.01949878, -0.00790939, -0.28767616,
                          -0.36679944, 0.88470376, 0.30047989]]},
                  {'0': ['cylinder', 0.0031622787937521935,
                         [0.96911395, -0.14034523, 0.20278415, -0.0212851,
                          -0.19417364, -0.03266359, 0.11902162]],
                   '1': ['sphere', 0.0031622787937521935,
                         [0.00925934, 0.13378771, -0.17467573, 0.30086511]],
                   '2': ['sphere', 0.0031622787937521935,
                         [-0.05544241, 0.0096046, -0.16684605, 0.312787]],
                   '3': ['cone', 0.0031622787937521935,
                         [0.19717112, -0.05250087, 0.02137174, -0.72527677,
                          0.32155749, -0.60874832, 0.25539228]],
                   '4': ['plane', 0.0031622787937521935,
                         [0.68560386, 0.05129248, 0.72616541, 0.20724298]],
                   '5': ['plane', 0.0031622787937521935,
                         [-0.11710124, 0.51656842, 0.84820074, 0.26170966]]},
                  {'0': ['plane', 0.0031622787937521935,
                         [0.88994884, -0.33300567, -0.31160596, -0.00795007]],
                   '1': ['cylinder', 0.0031622787937521935,
                         [0.91520083, -0.00487428, -0.40296859, -0.00869696,
                          -0.05420807, -0.01909638, 0.15573321]],
                   '2': ['plane', 0.0031622787937521935,
                         [0.58568865, 0.78024876, 0.21950042, 0.24486686]],
                   '3': ['cylinder', 0.0031622787937521935,
                         [-0.42272446, 0.66914088, 0.61119115, -0.0051266,
                          -0.01184947, 0.0094272, 0.2393316]],
                   '4': ['plane', 0.0031622787937521935,
                         [0.81059474, -0.58341247, -0.05065563, 0.10082482]],
                   '5': ['cylinder', 0.0031622787937521935,
                         [0.81407368, -0.52877921, 0.24015968, -0.05561622,
                          -0.09075011, -0.0112886, 0.21872561]]},
                  {'0': ['cylinder', 0.0031622787937521935,
                         [-0.55049419, 0.42467809, 0.71875221, 0.01150901,
                          -0.02269658, 0.02222516, 0.27232078]],
                   '1': ['cylinder', 0.0031622787937521935,
                         [-0.36524639, -0.41434494, 0.83361471, 0.00563349,
                          0.05789594, 0.03124525, 0.16207668]],
                   '2': ['plane', 0.0031622787937521935,
                         [-0.43128756, 0.15455972, 0.88887703, 0.02978933]],
                   '3': ['cone', 0.0031622787937521935,
                         [-0.08165269, -0.12635778, -0.13374726, 0.39912999,
                          -0.49486017, -0.77188659, 0.40162241]],
                   '4': ['sphere', 0.0031622787937521935,
                         [0.03843725, 0.3077119, 0.14769572, 0.21177337]],
                   '5': ['cone', 0.0031622787937521935,
                         [-0.14134699, -0.09660231, -0.02053604, 0.90961319,
                          -0.38628289, 0.15293577, 0.69823676]]},
                  {'0': ['plane', 0.0031622787937521935,
                         [0.43493968, 0.29704344, 0.8500545, 0.21480383]],
                   '1': ['plane', 0.0031622787937521935,
                         [-0.26040336, 0.87934816, 0.39866889, 0.06686213]],
                   '2': ['cone', 0.0031622787937521935,
                         [-0.01323564, -0.18578026, 0.11266863, 0.19977662,
                          -0.74863511, -0.63216686, 0.79564059]],
                   '3': ['cylinder', 0.0031622787937521935,
                         [0.49211833, 0.83431923, 0.24845743, -0.11674686,
                          0.07497236, -0.02051703, 0.10040118]],
                   '4': ['cone', 0.0031622787937521935,
                         [-0.00686818, 0.06704224, -0.14085199, 0.39107111,
                          0.07280203, -0.91747665, 0.76964527]],
                   '5': ['cone', 0.0031622787937521935,
                         [0.01982915, -0.06818972, 0.12407881, -0.6188345,
                          0.40322825, -0.67412972, 0.32394886]]}],
     'residual': [0.0031622787937521935, 0.0031622787937521935,
                  0.0031622787937521935, 0.0031622787937521935,
                  0.0031622787937521935, 0.0031622787937521935,
                  0.0031622787937521935, 0.0031622787937521935],
     'mean_dist': [0.003162279026582837, 0.003162279026582837,
                   0.003162279026582837, 0.003162279026582837,
                   0.003162279026582837, 0.003162279026582837,
                   0.003162279026582837, 0.003162279026582837],
     'p_cover': [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
     'covered': [10000, 10000, 10000, 10000, 10000, 10000, 10000, 10000]})
REF_FIT_KEYS = (
    {'key7': {'residual': [0.0035829475770394006, 0.0031622787937521935,
                           0.0031622787937521935, 0.0031622787937521935,
                           0.0031622787937521935, 0.004324578680098057,
                           0.0031622787937521935, 0.03692823462188244],
              'p_cover': [0.9871999621391296, 1.0, 1.0, 1.0, 1.0,
                          0.9459999799728394, 1.0, 0.7764999866485596]},
     'key8': {'residual': [0.0035829475770394006, 0.0031622787937521935,
                           0.0031622787937521935, 0.00316323545606186,
                           0.0031622787937521935, 0.004324578680098057,
                           0.0031622787937521935, 0.03692823462188244],
              'p_cover': [0.9871999621391296, 1.0, 1.0, 1.0, 1.0,
                          0.9459999799728394, 1.0, 0.7764999866485596]},
     'key9': {'residual': [0.0035829475770394006, 0.0031622787937521935,
                           0.0031622787937521935, 0.0031622787937521935,
                           0.0031622787937521935, 0.004324578680098057,
                           0.0031622787937521935, 0.03692823462188244],
              'p_cover': [0.9871999621391296, 1.0, 1.0, 1.0, 1.0,
                          0.9459999799728394, 1.0, 0.7764999866485596]}})
FIT_RTOL = 1e-3          # each segment's and each shape's residual (truth)
FIT_PARAM_ATOL = 1e-3    # canonical fit parameters, cuSOLVER against LAPACK
FIT_COVER_FLIPS = 5      # points a shape whose 0.01 test may flip (truth)
# end to end: the mean over JAX's keys, within JAX's spread across them and
# at least this floor (the port's subsamples come from another generator)
FIT_FLOOR = {"residual": 0.002, "p_cover": 0.03}
FIT_REPS = 3
# the smoke's own record_function ranges around the library's
FIT_SEGMENT = "fit_pipeline/segment_batch"
FIT_COVER = "fit_pipeline/p_coverage"


def _fit_key_means():
    return {m: [sum(r[m]) / len(r[m]) for r in REF_FIT_KEYS.values()]
            for m in ("residual", "p_cover")}


def canonical_params(v):
    """`scripts/jax_fit_reference.py canonical_params`: a geometric fit's
    parameters flat, the plane's (n, d) and the cylinder's axis turned so
    that their largest component is positive, the cylinder's centre
    reduced to its component across the axis."""
    import numpy as np

    name = v[0]
    flat = np.concatenate([np.asarray(a, np.float64).reshape(-1)
                           for a in v[1:]])
    if name in ("plane", "cylinder"):
        s = np.sign(flat[np.abs(flat[:3]).argmax()])
        flat[:4 if name == "plane" else 3] *= s
    if name == "cylinder":
        a = flat[:3] / np.linalg.norm(flat[:3])
        flat[3:6] -= (flat[3:6] @ a) * a
    return flat


def fit_metrics(ev, shapes, labels, types):
    """`bench.py` record 3 after the clustering: `residual_eval_batch` over
    the batch, then `p_coverage` of every shape. Returns (results,
    coverages)."""
    import numpy as np
    from torch.profiler import record_function
    from sednet_tpu_torch.fit import p_coverage

    res = ev.residual_eval_batch([
        {"points": s["points"], "normals": s["normals"],
         "labels": s["labels"].astype(np.int64),
         "cluster_ids": np.asarray(labels[i]).astype(np.int64),
         "pred_primitives": np.asarray(types[i]).astype(np.int64)}
        for i, s in enumerate(shapes)])
    with record_function(FIT_COVER):
        cov = [p_coverage(s["points"], res[i][1], device=DEVICE)
               for i, s in enumerate(shapes)]
    return res, cov


def check_fit_ground_truth(ev, shapes):
    """(a) The fit layer with nothing random in it: the true labels and
    types as the clustering. Every segment's type and residual, each
    shape's residual and mean distance (rtol FIT_RTOL), the canonical fit
    parameters (atol FIT_PARAM_ATOL) and the points within 0.01 (at most
    FIT_COVER_FLIPS a shape apart) against JAX's."""
    import numpy as np

    res, cov = fit_metrics(ev, shapes, [s["labels"] for s in shapes],
                           [s["prim"] for s in shapes])
    bad, err = [], {"segment_rel": 0.0, "shape_rel": 0.0, "param_abs": 0.0,
                    "mean_dist_rel": 0.0, "cover_flips": 0}

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    for i, ((loss, par, dist), (mean_d, cover)) in enumerate(zip(res, cov)):
        ref = REF_FIT_GT["segments"][i]
        if {str(k) for k in dist} != set(ref):
            bad.append((i, "segments", sorted(dist), sorted(ref)))
            continue
        for k, (name, d) in dist.items():
            ref_name, ref_d, ref_p = ref[str(k)]
            if name != ref_name:
                bad.append((i, k, name, ref_name))
                continue
            err["segment_rel"] = max(err["segment_rel"], rel(d, ref_d))
            err["param_abs"] = max(err["param_abs"], float(np.abs(
                canonical_params(par[k]) - np.asarray(ref_p)).max()))
        err["shape_rel"] = max(err["shape_rel"],
                               rel(loss[0], REF_FIT_GT["residual"][i]))
        err["mean_dist_rel"] = max(err["mean_dist_rel"],
                                   rel(mean_d, REF_FIT_GT["mean_dist"][i]))
        err["cover_flips"] = max(err["cover_flips"], abs(
            int(round(cover * N_POINTS)) - REF_FIT_GT["covered"][i]))
    ok = (not bad and max(err["segment_rel"], err["shape_rel"],
                          err["mean_dist_rel"]) <= FIT_RTOL
          and err["param_abs"] <= FIT_PARAM_ATOL
          and err["cover_flips"] <= FIT_COVER_FLIPS)
    return {"ok": ok, "max_err": err, "mismatch": bad,
            "residual": float(np.mean([r[0][0] for r in res])),
            "p_cover": float(np.mean([c[1] for c in cov])),
            "tol": {"rtol": FIT_RTOL, "param_atol": FIT_PARAM_ATOL,
                    "cover_flips": FIT_COVER_FLIPS}}


def _fit_batch(shapes):
    """The ground-truth segments of the batch as `_batched_geometric_fits`
    pads them: points, normals, weights (S, P_max)."""
    import numpy as np

    segs = [(s["points"][s["labels"] == k], s["normals"][s["labels"] == k])
            for s in shapes for k in np.unique(s["labels"])]
    p_max = max(p.shape[0] for p, _ in segs)
    pts = np.zeros((len(segs), p_max, 3), np.float32)
    nrm = np.zeros_like(pts)
    w = np.zeros((len(segs), p_max), np.float32)
    for i, (p, n) in enumerate(segs):
        pts[i, :len(p)], nrm[i, :len(p)], w[i, :len(p)] = p, n, 1.0
    return pts, nrm, w


def phase_fit_pipeline(models, shapes, x):
    """`bench.py` record 3 on the port: `segment_batch` on the 8 clouds,
    then `Evaluation.residual_eval_batch` (eval mode, no refit), then
    `p_coverage` on every shape. (a) `check_fit_ground_truth`; (b) residual
    and p_cover on the port's own labels within JAX's spread across keys
    (FIT_FLOOR at least). Launches from one run, which is also the
    warm-up; shapes/s the median of FIT_REPS synced runs with each part's
    host time; one run under torch.profiler for each stage's host and
    device ms; the batched fit and its SVD alone timed on the batch's
    segments."""
    import numpy as np
    import torch
    from torch.profiler import record_function
    from sednet_tpu_torch.fit import Evaluation, FittingModule
    from sednet_tpu_torch.fit.evaluation import STAGES
    from sednet_tpu_torch.fit.primitives import fit_all_types_packed
    from sednet_tpu_torch.predict import segment_batch

    model = models["inst"]
    ev = Evaluation(FittingModule(device=DEVICE))
    truth = check_fit_ground_truth(ev, shapes)
    gen = torch.Generator().manual_seed(5)
    split = {"segment_batch": [], "fits_residuals_coverage": []}

    def run():
        t0 = time.time()
        with record_function(FIT_SEGMENT):
            labels, types = segment_batch(model, x, generator=gen)
            labels, types = labels.cpu().numpy(), types.cpu().numpy()
        t1 = time.time()
        res, cov = fit_metrics(ev, shapes, labels, types)
        split["segment_batch"].append(t1 - t0)
        split["fits_residuals_coverage"].append(time.time() - t1)
        return labels, res, cov

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    labels, res, cov = run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("K1", "K2", "K3", "K6"):
        if counts[name] <= 0:
            raise AssertionError(f"fit_pipeline launched {name} no time")
    if labels.shape != (BATCH, N_POINTS) or len(res) != BATCH:
        raise AssertionError(f"fit_pipeline: labels {labels.shape}, "
                             f"{len(res)} results")
    got = {"residual": float(np.mean([r[0][0] for r in res])),
           "p_cover": float(np.mean([c[1] for c in cov]))}
    means = _fit_key_means()
    ref = {m: sum(v) / len(v) for m, v in means.items()}
    tol = {m: max(FIT_FLOOR[m], max(v) - min(v)) for m, v in means.items()}
    e2e_ok = all(np.isfinite(got[m]) and abs(got[m] - ref[m]) <= tol[m]
                 for m in got)
    for v in split.values():
        v.clear()
    ts = []
    for _ in range(FIT_REPS):
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        ts.append(time.time() - t0)
    med = float(np.median(ts))
    host_split = {k: float(np.median(v)) for k, v in split.items()}
    profile = _device_profile(run, "fit_pipeline_trace.json",
                              (FIT_SEGMENT,) + STAGES + (FIT_COVER,))

    pts, nrm, w = (torch.from_numpy(a).to(DEVICE) for a in _fit_batch(shapes))
    svd_in = w[..., None] * nrm
    pc, nc, wc = pts.cpu(), nrm.cpu(), w.cpu()
    t0 = time.time()
    fit_all_types_packed(pc, nc, wc)
    fits = {"segments": int(pts.shape[0]), "points_padded": int(pts.shape[1]),
            "packed_fit_cpu_ms": 1e3 * (time.time() - t0),
            "packed_fit_ms": time_ms(
                lambda: fit_all_types_packed(pts, nrm, w)),
            "svd_ms": time_ms(lambda: torch.linalg.svd(
                svd_in, full_matrices=False))}
    ok = truth["ok"] and e2e_ok
    emit({"phase": "fit_pipeline", "ok": ok,
          "shapes_per_s": BATCH / med, "batch_s_median": med,
          "batch_s_min": min(ts), "batch_s_max": max(ts),
          "timing": f"median of {FIT_REPS} synced batches after one",
          "host_split_s": host_split, "profile": profile,
          "peak_mem_gib": peak_gib, **got, "ref": ref, "tol": tol,
          "per_shape": [[r[0][0], c[1], int(lab.max()) + 1]
                        for r, c, lab in zip(res, cov, labels)],
          "ground_truth": truth, "fits": fits, "launches": counts})
    if not ok:
        raise AssertionError(f"fit_pipeline: ground truth {truth}, end to "
                             f"end {got} against {ref} +- {tol}")
    return counts


# fit_splines: seeded B-spline patches, (label, points) each: 2 an open
# spline, resampled to 1500 points; 0 a closed one, resampled to 1800
SPLINE_SEGMENTS = ((2, 2400), (2, 1100), (0, 2600), (0, 1300))
SPLINE_SEED = 10
SPLINE_NET_SEEDS = (31, 32)   # init_like_flax generators: open, closed
SPLINE_GRID_TOL = 1e-4        # control grid and surface, card against CPU
SPLINE_RES_RTOL = 1e-3        # a segment's residual, card against CPU


def spline_clouds():
    """SPLINE_SEGMENTS as fit_one_shape's segment dicts: points of a smooth
    random surface through the port's `sample_from_control_grid` (8 x 8
    control grid), plus noise 0.002. Open: a bumpy sheet; closed: a bumpy
    tube whose first and last control rows coincide."""
    import numpy as np
    import torch
    from sednet_tpu_torch.fit.bspline import (sample_from_control_grid,
                                              uniform_knot_bspline)

    rng = np.random.RandomState(SPLINE_SEED)
    nu, nv = uniform_knot_bspline(8, 8, 3, 3, 60)
    t = np.linspace(0.0, 1.0, 8)
    segs = []
    for i, (label, n) in enumerate(SPLINE_SEGMENTS):
        if label == 2:
            u, v = np.meshgrid(t - 0.5, t - 0.5, indexing="ij")
            ctrl = np.stack([u, v, rng.randn(8, 8) * 0.12], -1)
        else:
            ang = 2 * np.pi * t[:, None] + np.zeros((8, 8))
            r = 0.3 + rng.randn(8, 8) * 0.03
            r[-1] = r[0]
            ctrl = np.stack([r * np.cos(ang), r * np.sin(ang),
                             np.broadcast_to(t - 0.5, (8, 8))], -1)
        surf = sample_from_control_grid(
            torch.from_numpy(nu), torch.from_numpy(nv),
            torch.from_numpy(ctrl.reshape(1, 64, 3).astype(np.float32)), 8,
            8)[0].numpy()
        pts = surf[rng.choice(surf.shape[0], n, replace=False)]
        segs.append({"id": i, "label": label, "points": (
            pts + rng.randn(n, 3) * 0.002).astype(np.float32)})
    return segs


def _record_graphs(graphs, replay=()):
    """Wrap SplineNet's kNN so that every call appends (input, indices) to
    graphs, its indices popped from `replay` (moved to the input's device)
    while that holds any, else its own; returns the function that undoes
    it."""
    from sednet_tpu_torch.models import splinenet as sn

    real = sn.knn_indices
    replay = list(replay)

    def recording(x, k):
        idx = replay.pop(0).to(x.device) if replay else real(x, k)
        graphs.append((x.detach().clone(), idx))
        return idx

    sn.knn_indices = recording

    def undo():
        sn.knn_indices = real
    return undo


def _spline_run(fitter, segs, replay=(), count=False):
    """fit_one_shape(eval_mode=True) of the spline segments with its graphs
    and control grids recorded (graphs replayed from `replay`); returns
    the run's record, with the launch counts when count is set."""
    import numpy as np
    import torch
    from sednet_tpu_torch.fit import fit_one_shape
    from sednet_tpu_torch.fit.residuals import residual_loss_batched

    graphs, controls = [], []
    hooks = [net.register_forward_hook(
        lambda m, i, o: controls.append(o.detach()))
        for net in (fitter.open_net, fitter.closed_net)]
    undo = _record_graphs(graphs, replay)
    try:
        torch.cuda.synchronize()
        if count:
            reset_counts()
        t0 = time.time()
        params, recon = fit_one_shape(segs, fitter, eval_mode=True,
                                      rng=np.random.RandomState(0))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts() if count else None
    finally:
        undo()
        for h in hooks:
            h.remove()
    dist = residual_loss_batched({s["id"]: s["points"] for s in segs},
                                 params, sqrt=True, device=fitter.device)
    return {"graphs": graphs, "controls": controls, "recon": recon,
            "dist": dist, "wall_s": wall, "counts": counts}


def _spline_diff(a, b, sid, i):
    """Control grid and surface max abs difference and the residuals'
    relative difference of segment i (id sid) between runs a and b."""
    grid = float((a["controls"][i].cpu() - b["controls"][i].cpu())
                 .abs().max())
    surf = float((a["recon"][sid].cpu() - b["recon"][sid].cpu()).abs().max())
    ra, rb = float(a["dist"][sid][1]), float(b["dist"][sid][1])
    return {"grid_max_abs_diff": grid, "surface_max_abs_diff": surf,
            "residual_rel_diff": abs(ra - rb) / abs(rb),
            "within": max(grid, surf) <= SPLINE_GRID_TOL
            and abs(ra - rb) <= SPLINE_RES_RTOL * abs(rb)}


def phase_fit_splines():
    """Spline segments through `fit_one_shape(eval_mode=True)` and SplineNet
    at full width (grid 20, k 10, sample grid 30) on the card and on the
    CPU port, with the same weights (`init_like_flax`, SPLINE_NET_SEEDS)
    and the same RandomState: K1 launched 4 times a segment; each graph's
    neighbour sets, K1 against `topk_plain` on the card's inputs
    (`compare_with_plain`: swaps only inside near-ties) and the card's
    against the CPU's own; the control grids, surfaces and residuals held
    within SPLINE_GRID_TOL / SPLINE_RES_RTOL against the CPU run that
    replays the card's graphs (every segment), and against the CPU's own
    graphs where the four graphs' sets agree (reported elsewhere). Timed:
    one SplineNet forward at 1500 and 1800 points, one refit
    (if_optimize), and K1 at the new shape class in the `kernels` style.
    Returns (counts, K1 cases)."""
    import copy

    import torch
    from sednet_tpu_torch.fit import FittingModule, fit_one_shape
    from sednet_tpu_torch.models.init import init_like_flax
    from sednet_tpu_torch.models.splinenet import SplineNet
    from sednet_tpu_torch.ops.flash_topk import compare_with_plain, flash_topk

    nets = [init_like_flax(SplineNet(), torch.Generator().manual_seed(s))
            for s in SPLINE_NET_SEEDS]
    cpu_fitter = FittingModule(*copy.deepcopy(nets), device="cpu")
    card_fitter = FittingModule(*nets, device=DEVICE)
    segs = spline_clouds()
    card = _spline_run(card_fitter, segs, count=True)
    counts = card["counts"]
    if counts["K1"] != 4 * len(segs):
        raise AssertionError(f"fit_splines: K1 launched {counts['K1']} "
                             f"times for {len(segs)} spline segments")
    cpu = _spline_run(cpu_fitter, segs)
    replayed = _spline_run(cpu_fitter, segs,
                           replay=[idx for _, idx in card["graphs"]])

    per_seg, ok = [], True
    for i, s in enumerate(segs):
        rows = []
        sets_equal = True
        for g in range(4):
            xg, idx = card["graphs"][4 * i + g]
            _, idx_cpu = cpu["graphs"][4 * i + g]
            again, dist_k = flash_topk(xg, xg, 10, return_distances=True)
            cmp = compare_with_plain(xg, xg, 10, again, dist_k)
            # swaps only inside near-ties, which the resampled clouds'
            # close points make common (no MAX_SWAPPED share)
            if (cmp["bad_rows"] or not torch.equal(again, idx)
                    or max(cmp["max_abs_err"], cmp["nbr_err"]) > cmp["tol"]):
                raise AssertionError(f"fit_splines: K1 segment {i} graph "
                                     f"{g}: {cmp}")
            differ = int((idx.sort(-1).values.cpu()
                          != idx_cpu.sort(-1).values).any(-1).sum())
            sets_equal &= differ == 0
            rows.append({"width": int(xg.shape[-1]),
                         "tie_rows": cmp["tie_rows"],
                         "swapped_vs_plain": cmp["swapped_rows"],
                         "rows_differing_vs_cpu": differ})
        surf = card["recon"][s["id"]]
        if surf is None or not torch.isfinite(surf).all() or \
                tuple(surf.shape) != ((930 if s["label"] == 0 else 900), 3):
            raise AssertionError(f"fit_splines: segment {i} surface "
                                 f"{None if surf is None else surf.shape}")
        vs_replay = _spline_diff(card, replayed, s["id"], i)
        vs_cpu = _spline_diff(card, cpu, s["id"], i)
        ok &= vs_replay["within"] and (vs_cpu["within"] or not sets_equal)
        per_seg.append({"label": s["label"], "points": len(s["points"]),
                        "resampled": int(card["graphs"][4 * i][0].shape[1]),
                        "graphs": rows, "sets_equal_vs_cpu": sets_equal,
                        "vs_cpu_card_graphs": vs_replay,
                        "vs_cpu_own_graphs": vs_cpu,
                        "residual": float(card["dist"][s["id"]][1])})

    # one SplineNet forward at 1500 and 1800 points, and one refit
    by_n = {}
    for i, s in enumerate(segs):
        by_n.setdefault(int(card["graphs"][4 * i][0].shape[1]), i)
    forward_ms = {}
    for n, i in sorted(by_n.items()):
        xg = card["graphs"][4 * i][0]
        net = card_fitter.open_net if segs[i]["label"] == 2 \
            else card_fitter.closed_net
        w1 = torch.ones(xg.shape[:2], device=xg.device)
        with torch.no_grad():
            forward_ms[str(n)] = time_ms(lambda: net(xg, weights=w1), reps=5)
    closed = [s for s in segs if s["label"] == 0][:1]
    walls = {}
    for opt in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.time()
        fit_one_shape(closed, card_fitter, eval_mode=True, if_optimize=opt)
        torch.cuda.synchronize()
        walls.setdefault(opt, []).append(time.time() - t0)
    refit_s = min(walls[True]) - min(walls[False])

    # K1 at the new shape class: B = 1, k = 10, D = 3 / 64 / 128
    cases = [card["graphs"][4 * by_n[1500] + g][0] for g in (0, 1, 3)]
    cases.append(card["graphs"][4 * by_n[1800]][0])
    k1 = [check_topk(f"spline knn {tuple(xg.shape)} k=10", xg, xg, 10,
                     max_swapped=None) for xg in cases]
    emit({"phase": "fit_splines", "ok": ok, "segments": per_seg,
          "k1_launches": counts["K1"], "launches": counts,
          "fit_one_shape_s": {"card": card["wall_s"], "cpu": cpu["wall_s"]},
          "splinenet_forward_ms": forward_ms,
          "refit_s": refit_s, "refit_walls_s": {str(k): v for k, v in
                                                walls.items()},
          "k1": k1, "tol": {"grid": SPLINE_GRID_TOL,
                            "residual_rtol": SPLINE_RES_RTOL}})
    if not ok:
        raise AssertionError(f"fit_splines: {per_seg}")
    return counts, k1


CKPT_FIELDS = ("embedding", "type_log_prob", "edge_logits")


def phase_checkpoints(models, x):
    """The reference's `.pth` layout on the card: both models of
    checkpoints/bench_10k.npz written through
    `utils.torch_import.params_to_torch_state_dict` as a plain state dict,
    with DataParallel's `module.` prefix, and under "state_dict"
    (build/checkpoints_smoke/), each read back by `weights.load_checkpoint`
    (the path `run_prediction` takes) and run on the 8 headline clouds:
    the outputs must equal those of the `.npz`-loaded model bit for bit,
    with the same launches.
    Prints each load's seconds. The orbax read is not run here: writing an
    orbax directory needs orbax and JAX, which the smoke never imports,
    and tensorstore is absent beside the card; the CPU tests hold it."""
    import importlib.util
    import shutil

    import numpy as np
    import torch
    from sednet_tpu_torch.utils.torch_import import params_to_torch_state_dict
    from sednet_tpu_torch.weights import load_checkpoint, params_from_flat

    have_ts = importlib.util.find_spec("tensorstore") is not None
    print("checkpoints: orbax read skipped: writing an orbax directory needs "
          "orbax and JAX, which this smoke does not import; tensorstore "
          f"{'is' if have_ts else 'is not'} installed here; "
          "tests/test_torch_port_checkpoints.py holds the read on the CPU",
          flush=True)
    root = os.path.join(ROOT, "build", "checkpoints_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with np.load(os.path.join(ROOT, "checkpoints", "bench_10k.npz")) as flat:
        parts = {w: params_from_flat(flat, w) for w in ("inst", "type")}
    loads, ok = [], True
    for which, sd in parts.items():
        reset_counts()
        with torch.no_grad():
            want = models[which](x)
        torch.cuda.synchronize()
        want_counts = read_counts()
        ref = params_to_torch_state_dict(sd)
        for layout, obj in (("plain", ref),
                            ("module", {"module." + k: v
                                        for k, v in ref.items()}),
                            ("state_dict", {"state_dict": ref})):
            path = os.path.join(root, f"{which}_{layout}.pth")
            torch.save(obj, path)
            torch.cuda.synchronize()
            t0 = time.time()
            model = load_checkpoint(path, device=DEVICE)
            torch.cuda.synchronize()
            load_s = time.time() - t0
            reset_counts()
            with torch.no_grad():
                got = model(x)
            torch.cuda.synchronize()
            counts = read_counts()
            equal = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
                     for f in CKPT_FIELDS}
            ok &= all(equal.values()) and counts == want_counts
            loads.append({"model": which, "layout": layout, "load_s": load_s,
                          "bytes": os.path.getsize(path),
                          "bit_equal_to_npz": equal, "launches": counts,
                          "npz_launches": want_counts})
            del model, got
    emit({"phase": "checkpoints", "ok": ok, "loads": loads,
          "batch": list(x.shape),
          "orbax": "skipped: no orbax writer without JAX; CPU tests only",
          "tensorstore_installed": have_ts})
    if not ok:
        raise AssertionError(f"checkpoints: {loads}")


SPLINE_TRAIN_PATCHES = 40     # 36 train, 4 test (the 90/10 split)
SPLINE_TRAIN_POINTS = 700
SPLINE_TRAIN_STEPS = 20
SPLINE_TRAIN_RTOL = 1e-4      # step 1's loss and metrics, card against CPU
SPLINE_TRAIN_PARAM_TOL = 1e-4  # per leaf, relative L2, where sign(g) is sure
SPLINE_TRAIN_GRAD_TOL = 5e-3  # per leaf, relative L2 (float32 conditioning)
CHAMFER_ATOL = 1e-6           # chamfer's gradient, card against CPU
# biases that feed a train-mode BatchNorm over the batch, which removes any
# shift: their gradient is 0 in exact arithmetic, rounding noise here
SPLINE_ZERO_GRAD = ("bn5.bias", "conv6.bias", "conv7.bias")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def spline_step_vs_cpu(points, ctrl, closed):
    """Step 1 of `train_spline_arrays`' loop (its init, its first batch) on
    the card and on the CPU, the CPU replaying the card's four K1 graphs:
    the loss and metrics within SPLINE_TRAIN_RTOL; each gradient within
    SPLINE_TRAIN_GRAD_TOL relative L2 (SPLINE_ZERO_GRAD: rounding noise on
    both sides); each parameter after Adam's update within
    SPLINE_TRAIN_PARAM_TOL relative L2 on the elements whose gradient sign
    is sure (the CPU's gradient more than 10 times the two sides'
    difference: Adam's first step is lr * sign(g)), and every element
    moved by at most lr; the running statistics within
    SPLINE_TRAIN_PARAM_TOL. Returns (record, the card's graphs)."""
    import copy

    import numpy as np
    import torch
    from sednet_tpu_torch.fit.bspline import uniform_knot_bspline
    from sednet_tpu_torch.models.init import init_like_flax
    from sednet_tpu_torch.models.splinenet import SplineNet
    from sednet_tpu_torch.splinenet_train import make_spline_train_step

    n_train = max(int(len(points) * 0.9), 1)
    sel = np.random.RandomState(0).choice(n_train, 4, replace=False)
    nu, nv = uniform_knot_bspline(20, 20, 3, 3, 30)
    init = init_like_flax(SplineNet(), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in init.state_dict().items()}
    runs, card_graphs = {}, []
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(init).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                               betas=(0.9, 0.999), eps=1e-8)
        step, _ = make_spline_train_step(model, opt, nu, nv, closed=closed,
                                         loss_weight=0.9, grid=20)
        graphs = []
        undo = _record_graphs(graphs, [g for _, g in card_graphs])
        try:
            metrics = step(torch.from_numpy(points[sel]).to(dev),
                           torch.from_numpy(ctrl[sel]).to(dev))
        finally:
            undo()
        card_graphs = card_graphs or graphs
        runs[dev] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu().double()
                      for n, p in model.named_parameters()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    (cm, cg, cs), (pm, pg, ps) = runs[DEVICE], runs["cpu"]
    total = math.sqrt(sum(float((g * g).sum()) for g in pg.values()))
    rec = {"loss_step1": cm["loss"], "cpu_loss_step1": pm["loss"],
           "metric_rel_err": {k: abs(cm[k] - pm[k]) / abs(pm[k]) for k in pm},
           "grad_rel_l2": {}, "param_rel_l2": {}, "sure_share": {},
           "zero_grad_norm": {}, "stats_rel_l2": {}}
    moved = 0.0
    for name in pg:
        for side in (cs, ps):
            moved = max(moved, float((side[name] - before[name]).abs().max()))
        if name in SPLINE_ZERO_GRAD:
            rec["zero_grad_norm"][name] = max(
                float(cg[name].norm()), float(pg[name].norm())) / total
            continue
        rec["grad_rel_l2"][name] = _rel(cg[name], pg[name])
        sure = pg[name].abs() > 10 * (cg[name] - pg[name]).abs()
        rec["sure_share"][name] = float(sure.double().mean())
        rec["param_rel_l2"][name] = _rel(cs[name][sure].double(),
                                         ps[name][sure].double())
    for name in ps:
        if name.endswith((".mean", ".var")):
            rec["stats_rel_l2"][name] = _rel(cs[name].double(),
                                             ps[name].double())
    rec["moved_max"] = moved
    ok = (max(rec["metric_rel_err"].values()) <= SPLINE_TRAIN_RTOL
          and max(rec["grad_rel_l2"].values()) <= SPLINE_TRAIN_GRAD_TOL
          and max(rec["param_rel_l2"].values()) <= SPLINE_TRAIN_PARAM_TOL
          and min(rec["sure_share"].values()) > 0.9
          and max(rec["zero_grad_norm"].values()) <= 1e-5
          and max(rec["stats_rel_l2"].values()) <= SPLINE_TRAIN_PARAM_TOL
          and moved <= 1e-3 + 1.2e-7)
    for key in ("grad_rel_l2", "param_rel_l2", "stats_rel_l2"):
        worst = max(rec[key], key=rec[key].get)
        rec[key] = {"max": rec[key][worst], "leaf": worst,
                    "median": sorted(rec[key].values())[len(rec[key]) // 2]}
    rec["sure_share"] = min(rec["sure_share"].values())
    rec["ok"] = ok
    if not ok:
        raise AssertionError(f"splinenet_train: step 1 against the CPU {rec}")
    return rec, card_graphs


def check_chamfer_backward(points, ctrl):
    """Chamfer's backward (`ops.chamfer.chamfer_index`, index_add_) on the
    card against the CPU at the loss's shapes: the 30 x 30 surface of the
    true grids (4, 900, 3) against the points (4, 700, 3), with seeded
    weights on d1 and d2. The distances within CHAMFER_ATOL; the gradients
    within CHAMFER_ATOL on the rows whose nearest neighbours agree and that
    no differing pair touches; timed forward and backward on the card."""
    import numpy as np
    import torch
    from sednet_tpu_torch.fit.bspline import (sample_from_control_grid,
                                              uniform_knot_bspline)
    from sednet_tpu_torch.ops.chamfer import chamfer_index, nn_distance

    nu, nv = (torch.from_numpy(a) for a in uniform_knot_bspline(20, 20, 3, 3,
                                                                30))
    x = sample_from_control_grid(nu, nv, torch.from_numpy(
        ctrl[:4].reshape(4, 400, 3)), 20, 20)
    y = torch.from_numpy(points[:4])
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    w1, w2 = torch.rand(4, 900, generator=gen), torch.rand(4, 700,
                                                           generator=gen)
    out = {}
    for dev in (DEVICE, "cpu"):
        tx = x.to(dev).detach().requires_grad_()
        ty = y.to(dev).detach().requires_grad_()
        d1, d2 = chamfer_index(tx, ty)
        ((w1.to(dev) * d1).sum() + (w2.to(dev) * d2).sum()).backward()
        idx = nn_distance(tx.detach(), ty.detach())[2:]
        out[dev] = [t.detach().cpu() for t in (d1, d2, tx.grad, ty.grad,
                                                *idx)]
    (d1c, d2c, gxc, gyc, i1c, i2c), (d1p, d2p, gxp, gyp, i1p, i2p) = \
        out[DEVICE], out["cpu"]
    ok_x, ok_y = (i1c == i1p), (i2c == i2p)
    for b in range(4):   # rows a differing pair adds into
        ok_x[b, i2c[b][~(i2c[b] == i2p[b])]] = False
        ok_x[b, i2p[b][~(i2c[b] == i2p[b])]] = False
        ok_y[b, i1c[b][~(i1c[b] == i1p[b])]] = False
        ok_y[b, i1p[b][~(i1c[b] == i1p[b])]] = False
    rec = {"shapes": [list(x.shape), list(y.shape)],
           "dist_max_abs_diff": max(float((d1c - d1p).abs().max()),
                                    float((d2c - d2p).abs().max())),
           "grad_max_abs_diff": max(float((gxc - gxp)[ok_x].abs().max()),
                                    float((gyc - gyp)[ok_y].abs().max())),
           "grad_scale": max(float(gxp.abs().max()), float(gyp.abs().max())),
           "index_rows_differing": int((~(i1c == i1p)).sum()
                                       + (~(i2c == i2p)).sum()),
           "rows_compared": int(ok_x.sum() + ok_y.sum())}
    xc, yc = x.to(DEVICE), y.to(DEVICE)
    w1c, w2c = w1.to(DEVICE), w2.to(DEVICE)

    def fwd_bwd():
        tx, ty = xc.detach().requires_grad_(), yc.detach().requires_grad_()
        d1, d2 = chamfer_index(tx, ty)
        ((w1c * d1).sum() + (w2c * d2).sum()).backward()
        return tx.grad, ty.grad

    again = fwd_bwd()
    rec["bit_equal_across_card_runs"] = bool(
        torch.equal(again[0].cpu(), gxc) and torch.equal(again[1].cpu(), gyc))
    rec["fwd_bwd_ms"] = time_ms(fwd_bwd)
    rec["ok"] = (max(rec["dist_max_abs_diff"], rec["grad_max_abs_diff"])
                 <= CHAMFER_ATOL and rec["rows_compared"] >= 0.99 * 6400)
    if not rec["ok"]:
        raise AssertionError(f"splinenet_train: chamfer {rec}")
    return rec


def _kernel_share(trace, key):
    """Device ms of the kernels whose name holds `key`, and of all kernels,
    in a chrome trace."""
    with open(trace) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return (sum(e["dur"] for e in evs if key in e["name"]) / 1e3,
            sum(e["dur"] for e in evs) / 1e3)


def phase_splinenet_train():
    """SplineNet's supervised trainer at full width (grid 20, k 10, 700
    points, batch 4, Adam 1e-3, loss_weight 0.9), open and closed, on
    `make_spline_patches(40, 700, grid 20, seed 0)` (no h5py beside the
    card: `train_spline_arrays`, the loop `train_splinenet` runs over its
    h5 file): step 1 held to the CPU (`spline_step_vs_cpu`); 20 steps and
    the evaluate of the test tenth into build/splinenet_train/<kind>/, K1
    4 times a forward; one step's median ms, its K1 share under
    torch.profiler, peak memory; chamfer's backward held to the CPU at the
    loss's shapes; K1 at the four graph shapes in the `kernels` style.
    Returns (K1 launches of the two loops, K1 cases)."""
    import shutil

    import numpy as np
    import torch
    from sednet_tpu_torch.fit.bspline import uniform_knot_bspline
    from sednet_tpu_torch.splinenet_train import (make_spline_patches,
                                                  make_spline_train_step,
                                                  train_spline_arrays)

    root = os.path.join(ROOT, "build", "splinenet_train")
    shutil.rmtree(root, ignore_errors=True)
    nu, nv = uniform_knot_bspline(20, 20, 3, 3, 30)
    kinds, k1_loops, cases, chamfer = {}, 0, [], None
    for kind in ("open", "closed"):
        closed = kind == "closed"
        t0 = time.time()
        points, ctrl = make_spline_patches(
            n_patches=SPLINE_TRAIN_PATCHES, n_points=SPLINE_TRAIN_POINTS,
            grid=20, seed=0, closed=closed)
        data_s = time.time() - t0
        versus, graphs = spline_step_vs_cpu(points, ctrl, closed)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.time()
        state, history = train_spline_arrays(
            points, ctrl, closed=closed, steps=SPLINE_TRAIN_STEPS,
            eval_every=SPLINE_TRAIN_STEPS, run_dir=os.path.join(root, kind),
            seed=0, device=DEVICE)
        torch.cuda.synchronize()
        loop_s = time.time() - t0
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {key: (4 * (SPLINE_TRAIN_STEPS + 1) if key == "K1" else 0)
                for key in counts}
        if counts != want:
            raise AssertionError(f"splinenet_train {kind}: launches {counts}, "
                                 f"expected {want}")
        rec = history[-1]
        if (len(history) != 1 or rec["step"] != SPLINE_TRAIN_STEPS
                or not all(map(math.isfinite, rec.values()))):
            raise AssertionError(f"splinenet_train {kind}: history {history}")
        k1_loops += counts["K1"]

        step, _ = make_spline_train_step(state.model, state.optimizer, nu, nv,
                                         closed=closed, loss_weight=0.9,
                                         grid=20)
        x = torch.from_numpy(points[:4]).to(DEVICE)
        c = torch.from_numpy(ctrl[:4]).to(DEVICE)
        reset_counts()
        step(x, c)
        torch.cuda.synchronize()
        per_step = read_counts()
        if per_step["K1"] != 4:
            raise AssertionError(f"splinenet_train: one step's launches "
                                 f"{per_step}")
        step_ms = time_ms(lambda: step(x, c), reps=10, warmup=2)
        trace = f"splinenet_train_{kind}_trace.json"
        prof = _device_profile(lambda: step(x, c), trace)
        prof.pop("stages")
        k1_ms, kernels_ms = _kernel_share(os.path.join(ROOT, "build", trace),
                                          "walk_")
        kinds[kind] = {
            "data_s": data_s, "loop_s": loop_s,
            "loop_step_s_with_eval": loop_s / SPLINE_TRAIN_STEPS,
            "loss_step1": versus["loss_step1"], "loss_step20": rec["loss"],
            "history": history, "launches": counts,
            "launches_per_step": per_step, "step_ms": step_ms,
            "patches_per_s": 4e3 / step_ms, "step_profile": prof,
            "k1_device_ms": k1_ms, "kernels_device_ms": kernels_ms,
            "k1_share": k1_ms / kernels_ms if kernels_ms else None,
            "peak_gib": peak_gib,
            "peak_above_start_gib": peak_gib - start_bytes / 2 ** 30,
            "card_vs_cpu_step1": versus}
        if chamfer is None:
            chamfer = check_chamfer_backward(points, ctrl)
            cases = [check_topk(f"SplineNet train graph {g + 1}, "
                                f"{tuple(xg.shape)} k=10", xg, xg, 10,
                                max_swapped=None)
                     for g, (xg, _) in enumerate(graphs)]
        del state, step
        torch.cuda.empty_cache()
    emit({"phase": "splinenet_train", "ok": True,
          "config": {"grid": 20, "k": 10, "points": SPLINE_TRAIN_POINTS,
                     "batch": 4, "lr": 1e-3, "loss_weight": 0.9,
                     "patches": SPLINE_TRAIN_PATCHES,
                     "steps": SPLINE_TRAIN_STEPS},
          "kinds": kinds, "chamfer": chamfer, "k1": cases,
          "tol": {"metrics_rtol": SPLINE_TRAIN_RTOL,
                  "param_rel_l2": SPLINE_TRAIN_PARAM_TOL,
                  "grad_rel_l2": SPLINE_TRAIN_GRAD_TOL,
                  "chamfer_atol": CHAMFER_ATOL}})
    return k1_loops, cases


def distinct_fraction(idx, order, run):
    """The distinct neighbour rows that a run of `run` consecutive positions
    of `order` reads, over the run * K rows it reads, averaged over the full
    runs of every shape: the share of K6's row reads in a block that are
    not repeats (a count, no time). idx (B, N, K), order (B, N)."""
    import torch

    b, n, k = idx.shape
    rows = torch.gather(idx.clamp(0, n - 1), 1,
                        order.long()[..., None].expand(-1, -1, k))
    full = n // run * run
    s = rows[:, :full].reshape(b, n // run, run * k).sort(dim=-1).values
    distinct = 1 + (s[..., 1:] != s[..., :-1]).sum(-1)
    return float(distinct.double().mean()) / (run * k)


def check_gather_reduce(name, a, idx, order):
    """K6 against gather_reduce_plain on the same table and graph: the max
    exact (the same elements), the sum and the sum of squares within
    1e-5 * K * max|a| (and max|a|^2), the reassociation bound of K terms
    summed in k order against torch's order. The kernel runs as the encoder
    runs it, along the Morton order of the points, and gives the same bits
    along the identity; both are timed (`ms` one call with its host time,
    `device_ms` calls back to back), with the distinct-row fraction of each
    order (`distinct_fraction`, at the kernel's run of 32 rows, at 8 and at
    64) and, as a yardstick, three F.embedding_bag calls (sum of a, sum of
    a*a, max of a over the flattened table), which are three calls and not
    one library call for K6's function."""
    import torch
    import torch.nn.functional as F
    from sednet_tpu_torch.ops.graph import gather_reduce, gather_reduce_plain

    s, sq, mx = gather_reduce(a, idx, order)
    ident = gather_reduce(a, idx)
    ps, psq, pmx = gather_reduce_plain(a, idx)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(u, w) for u, w in zip((s, sq, mx), ident))
    b, n, c = a.shape
    k = idx.shape[-1]
    amax = float(a.abs().max())
    errs = {"mx_err": float((mx - pmx).abs().max()),
            "sum_err": float((s - ps).abs().max()),
            "sq_err": float((sq - psq).abs().max())}
    tol = {"sum_tol": 1e-5 * k * amax, "sq_tol": 1e-5 * k * amax * amax}
    if (not same_bits or errs["mx_err"] != 0.0
            or errs["sum_err"] > tol["sum_tol"]
            or errs["sq_err"] > tol["sq_tol"]):
        raise AssertionError(f"K6 {name}: {errs} {tol}, same bits under the "
                             f"Morton order and the identity: {same_bits}")
    ident_order = torch.arange(n, dtype=torch.int32, device=a.device)
    ident_order = ident_order.expand(b, -1)
    frac = {str(r): {"morton": distinct_fraction(idx, order, r),
                     "identity": distinct_fraction(idx, ident_order, r)}
            for r in (8, 32, 64)}
    flat = a.reshape(b * n, c)
    flat2 = flat * flat
    bags = (idx.clamp(0, n - 1) + n * torch.arange(
        b, device=a.device)[:, None, None]).reshape(b * n, k)

    def three_bags():
        F.embedding_bag(bags, flat, mode="sum")
        F.embedding_bag(bags, flat2, mode="sum")
        F.embedding_bag(bags, flat, mode="max")

    # add, square, add, max per gathered value; each input read once (the
    # table, the int64 graph, the int32 order), each output written once
    bms, by = bound_ms(4 * b * n * k * c,
                       4 * a.numel() + 8 * idx.numel() + 4 * b * n
                       + 3 * 4 * b * n * c)
    return {"case": name, "shape": [b, n, k, c], **errs, **tol,
            "max_abs_err": max(errs.values()),
            "morton_identity_same_bits": same_bits,
            "distinct_fraction": frac,
            "ms": time_ms(lambda: gather_reduce(a, idx, order), reps=20),
            "identity_ms": time_ms(lambda: gather_reduce(a, idx), reps=20),
            "device_ms": burst_ms(lambda: gather_reduce(a, idx, order)),
            "identity_device_ms": burst_ms(lambda: gather_reduce(a, idx)),
            "plain_ms": time_ms(lambda: gather_reduce_plain(a, idx), reps=5),
            "library_ms": None,
            "embedding_bag_three_calls_ms": time_ms(three_bags, reps=5),
            "bound_ms": bms, "bound_by": by,
            "row_read_bytes": 4 * b * n * k * c}


def _sparse_operator(xyz, nrm):
    """The farthest-50 graph of one cloud as the matrix-free solver builds
    it: (idx, coef, sorted layout (src, coef, dest, ends))."""
    from sednet_tpu_torch.cluster.spectral import (_sorted_transpose_layout,
                                                   normal_affinity_sparse)

    idx, w, rsq = normal_affinity_sparse(xyz, nrm,
                                         k=predict_cfg().spectral_knn)
    coef = w * rsq[idx] * rsq[:, None]
    return idx, coef, _sorted_transpose_layout(idx, coef)


def _check_segsum_layout(name, vals_t, dest_s, ends_s, counts, extra=None):
    """K5 on one sorted layout: against its plain version (the segmented
    scan) within 1e-5 of each segment's sum of |entries| (both add
    pairwise, in other orders); bit-identical across two launches; exactly
    0 at every empty destination; with the times of the kernel, the plain
    version and torch.segment_reduce beside the bound. `extra` holds what
    is held against another reference, as a dict of name -> (reference,
    tolerance relative to the sum of |entries|)."""
    import torch
    from sednet_tpu_torch.ops import cuda_kernels as ck

    got = ck.segsum_sorted_scan(vals_t, dest_s, ends_s)
    again = ck.segsum_sorted_scan(vals_t, dest_s, ends_s)
    want = ck.segsum_sorted_scan_plain(vals_t, dest_s, ends_s)
    scale = ck.segsum_sorted_scan_plain(vals_t.abs(), dest_s, ends_s)
    torch.cuda.synchronize()
    refs = {"plain": (want, 1e-5), **(extra or {})}
    rel = {key: float(((got - ref).abs() / scale.clamp_min(1e-30)).max())
           for key, (ref, _) in refs.items()}
    identical = torch.equal(got, again)
    empty_zero = bool((got[counts == 0] == 0).all())
    if not (identical and empty_zero
            and all(rel[key] <= tol for key, (_, tol) in refs.items())):
        raise AssertionError(f"K5 {name}: rel {rel}, identical {identical}, "
                             f"empty destinations zero {empty_zero}")
    m, e = vals_t.shape
    n = ends_s.shape[0]
    vals_e = vals_t.T.contiguous()   # segment_reduce sums along axis 0
    lib = torch.segment_reduce(vals_e, "sum", lengths=counts, axis=0)
    # vals_t, ends and the output: the kernel never reads dest
    bms, by = bound_ms(m * e, 4 * (m * e + n + n * m))
    return {"case": name, "shape": [m, e, n],
            "nonempty_destinations": int((counts > 0).sum()),
            "longest_segment": int(counts.max()),
            **{f"rel_err_vs_{key}": v for key, v in rel.items()},
            **{f"tol_{key}": tol for key, (_, tol) in refs.items()},
            "bit_identical": identical, "empty_zero": empty_zero,
            "max_abs_err": float((got - want).abs().max()),
            "library_rel_err": float(((lib - want).abs()
                                      / scale.clamp_min(1e-30)).max()),
            "ms": time_ms(lambda: ck.segsum_sorted_scan(vals_t, dest_s,
                                                        ends_s)),
            "device_ms": burst_ms(lambda: ck.segsum_sorted_scan(
                vals_t, dest_s, ends_s)),
            "plain_ms": time_ms(lambda: ck.segsum_sorted_scan_plain(
                vals_t, dest_s, ends_s), reps=5),
            "library_ms": time_ms(lambda: torch.segment_reduce(
                vals_e, "sum", lengths=counts, axis=0)),
            "library": "torch.segment_reduce on the (E, m) layout",
            "bound_ms": bms, "bound_by": by}


def check_segsum(m, idx, coef, layout, gen):
    """K5 on the sorted layout of one cloud's graph at block width m, on
    the entries of a random (N, m) block as the "pallas" matvec builds them
    (`_check_segsum_layout`), also against index_add_ of the same entries
    (atomic adds in any order, up to thousands a destination) within 1e-4
    of the sum of |entries|."""
    import torch

    src_s, coef_s, dest_s, ends_s = layout
    n = idx.shape[0]
    v = torch.randn((n, m), generator=gen).to(DEVICE)
    vals_t = (coef_s[None, :] * torch.index_select(v.T.contiguous(), 1,
                                                   src_s)).contiguous()
    scatter = torch.zeros_like(v).index_add_(
        0, idx.reshape(-1), (coef[..., None] * v[:, None, :]).reshape(-1, m))
    counts = torch.bincount(idx.reshape(-1), minlength=n)
    return _check_segsum_layout(
        f"farthest-50 graph of a {n}-point cloud, m={m}", vals_t, dest_s,
        ends_s, counts, {"scatter": (scatter, 1e-4)})


def check_segsum_single(m, e, n, gen):
    """K5 where one destination (the middle one) holds all E entries, the
    rest empty: the layout that one block a destination served worst.
    Entries over six decades, as the quirk affinity's coefficients."""
    import torch

    d = n // 2
    vals_t = (torch.randn((m, e), generator=gen)
              * 10.0 ** (6 * torch.rand((1, e), generator=gen) - 3)).to(DEVICE)
    dest = torch.full((e,), d, dtype=torch.int32, device=DEVICE)
    counts = torch.zeros(n, dtype=torch.int64, device=DEVICE)
    counts[d] = e
    ends = torch.cumsum(counts, 0).to(torch.int32)
    return _check_segsum_layout(
        f"one destination holding all {e} entries, m={m}",
        vals_t.contiguous(), dest, ends, counts)


def phase_kernels_slice3(models, x, big_x):
    """K6 at the encoder's three layers (the signed table a * sign(scale)
    that edge_conv_factored gives it, on K1's graph of the layer input),
    along the Morton order of the points as the encoder runs it, with the
    order's own time beside the three launches; K5 on one 32768-point
    cloud's farthest-50 graph at m = 12 and 36, and on as many entries all
    at one destination at m = 36."""
    import torch
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.graph import locality_order

    xyz = x[..., :3].contiguous()
    order = locality_order(xyz)
    k6 = [check_gather_reduce(name, a, flash_topk(g, g, K, metric=metric),
                              order)
          for name, g, a, metric in _fused_layer_inputs(models["inst"], x)]
    order_ms = time_ms(lambda: locality_order(xyz), reps=20)
    order_device_ms = kernel_ms(lambda: locality_order(xyz))
    idx, coef, layout = _sparse_operator(big_x[0, :, :3].contiguous(),
                                         big_x[0, :, 3:6].contiguous())
    gen = torch.Generator().manual_seed(6)
    k5 = [check_segsum(m, idx, coef, layout, gen) for m in (12, 36)]
    k5.append(check_segsum_single(36, layout[2].shape[0], idx.shape[0], gen))
    out = {"K5": k5, "K6": k6}
    # what one forward gains from the order on the device: K6's three
    # launches along the identity, less the same along the Morton order and
    # the order itself (its host time hides behind K1's device time)
    forward = {"order_ms": order_ms, "order_device_ms": order_device_ms,
               "k6_three_layers_morton_device_ms": sum(
                   c["device_ms"] for c in k6),
               "k6_three_layers_identity_device_ms": sum(
                   c["identity_device_ms"] for c in k6)}
    forward["net_device_gain_ms"] = (
        forward["k6_three_layers_identity_device_ms"]
        - forward["k6_three_layers_morton_device_ms"] - order_device_ms)
    emit({"phase": "kernels_slice3", "ok": True, "results": out,
          "encoder_forward": forward})
    return out


def big_cfg():
    from sednet_tpu_torch.config import Config

    return Config(**{**PREDICT_KW, "num_points": BIG_POINTS})


def _metrics(shapes, labels, types):
    import numpy as np
    from sednet_tpu_torch.metrics import siou_matched_segments_usecd_batch

    mets = siou_matched_segments_usecd_batch(
        [s["labels"].astype(np.int64) for s in shapes], list(labels),
        list(types), [s["prim"].astype(np.int64) for s in shapes],
        [s["points"] for s in shapes], device=DEVICE)
    return {"inst_iou": float(np.mean([r[0] for r in mets])),
            "type_iou": float(np.mean([r[1] for r in mets])),
            "inst_recall": float(np.mean([r[4] for r in mets]))}


def phase_spectral_matfree(models, shapes, x, inputs):
    """The matrix-free solver in each A^T v layout on the large clouds, then
    the "pallas" (K5) enrichment through cluster_batch and the metrics.
    Eigenvectors are not held across layouts: the farthest quirk's are
    localised, and the row normalisation turns last-ulp differences into
    noise (tests/test_cluster.py:226-235); the operator and the downstream
    result are held instead."""
    import numpy as np
    import torch
    from sednet_tpu_torch.cluster import cluster_batch
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.cluster.spectral import (TRANSPOSE_MODES,
                                                   _default_vocab_cap,
                                                   hpnet_enrich,
                                                   matfree_matvec,
                                                   normal_affinity_sparse,
                                                   spectral_eigvecs_matfree)
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.predict import (cluster_settings,
                                          make_first_layer_idx, make_forward)

    cfg = big_cfg()
    x0s, sels = inputs
    b, n = x.shape[:2]
    xyz, nrm = x[..., :3].contiguous(), x[..., 3:6].contiguous()
    solves = {}
    for mode in TRANSPOSE_MODES:
        secs, k5 = [], []
        for i in range(b):
            torch.cuda.synchronize()
            before = ck.segsum_sorted_scan.launches
            t0 = time.time()
            v = spectral_eigvecs_matfree(xyz[i], nrm[i], x0s[i],
                                         transpose_mode=mode)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            k5.append(ck.segsum_sorted_scan.launches - before)
            dev = float((torch.linalg.vector_norm(v, dim=1) - 1).abs().max())
            if not bool(torch.isfinite(v).all()) or dev > 1e-4:
                raise AssertionError(f"{mode}: rows not finite and unit "
                                     f"({dev})")
        solves[mode] = {"solve_s": secs, "k5_launches_per_solve": k5}
    if min(solves["pallas"]["k5_launches_per_solve"]) <= 0:
        raise AssertionError("the pallas layout launched K5 no time")

    # each layout's operator on one random (N, 36) block against the
    # scatter layout's, relative to |A| |v| (the same operator on |v|:
    # every coefficient is >= 0); atomic and pairwise sums of up to
    # thousands of terms stay within 1e-4 of it, a wrong layout does not
    gen = torch.Generator().manual_seed(7)
    block = torch.randn((n, 36), generator=gen).to(DEVICE)
    ops = {mode: matfree_matvec(xyz[0], nrm[0], transpose_mode=mode)
           for mode in TRANSPOSE_MODES}
    ref = ops["scatter"](block)
    scale = ops["scatter"](block.abs()).clamp_min(1e-30)
    matvec_err = {mode: float(((op(block) - ref).abs() / scale).max())
                  for mode, op in ops.items()}
    del ops
    if max(matvec_err.values()) > 1e-4:
        raise AssertionError(f"matvec layouts disagree: {matvec_err}")
    n_unique = [int(torch.unique(normal_affinity_sparse(
        xyz[i], nrm[i], k=cfg.spectral_knn)[0]).numel()) for i in range(b)]

    # the "pallas" enrichment downstream, as predict_shapes runs it
    with torch.no_grad():
        idx1 = make_first_layer_idx(cfg)(x)
        type_lp = models["type"](x, idx1).type_log_prob
        _, emb, _ = make_forward(models["inst"])(x, idx1)
    torch.cuda.synchronize()
    reset_counts()
    emb_n = torch.stack([hpnet_enrich(
        emb[i], xyz[i], nrm[i], x0=x0s[i], normal_smooth_w=cfg.normal_smooth_w,
        sigma=cfg.spectral_sigma, knn=cfg.spectral_knn,
        eig_k=cfg.spectral_eigvecs, transpose_mode="pallas")
        for i in range(b)])
    labels, nums, _ = cluster_batch(emb_n.contiguous(), sels=sels,
                                    **cluster_settings(cfg, n))
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["K5"] <= 0:
        raise AssertionError("the pallas enrichment launched K5 no time")
    # K2b on these embeddings at each cloud's bandwidth, as predict_bigcloud
    # runs it (2, 32768, 140 at 160), with SDPA's time beside it
    bw = torch.stack([torch.clamp_min(compute_bandwidth(
        emb_n[i], cfg.ms_num_samples, np.float32(cfg.ms_quantile),
        sel=sels[i]), 0.003) for i in range(b)])
    k2b, _ = _check_k2b_wide(emb_n.contiguous(), bw, f"{b} clouds,")
    got = _metrics(shapes, labels.cpu().numpy(),
                   type_lp.argmax(-1).cpu().numpy())
    ok = all(abs(got[m] - REF_BIG_MEAN[m]) <= BIG_TOL[m] for m in got)
    emit({"phase": "spectral_matfree", "ok": ok, "solves": solves,
          "matvec_rel_err_vs_scatter": matvec_err, "matvec_tol": 1e-4,
          "vocab": {"distinct_targets": n_unique,
                    "cap": _default_vocab_cap(n)},
          "pallas_enrichment": {**got, "num_clusters": nums.tolist(),
                                "launches": counts},
          "ref": REF_BIG_MEAN, "tol": BIG_TOL, "K2b": k2b})
    if not ok:
        raise AssertionError(f"pallas enrichment metrics {got} not within "
                             f"{BIG_TOL} of {REF_BIG_MEAN}")
    return counts, k2b


def phase_predict_bigcloud(models, shapes, inputs):
    """predict_shapes on the 2 large clouds at N = 32768: the auto policy
    takes the matrix-free solver ("scatter"), as the JAX package does."""
    import numpy as np

    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    cfg = big_cfg()
    if batch["points"].shape[1] <= cfg.spectral_dense_max_n:
        raise AssertionError("predict_bigcloud: the clouds fit the dense "
                             "affinity; the matrix-free path would not run")
    rec, labels, _ = phase_predict("predict_bigcloud", models, batch, inputs,
                                   reps=2, cfg=cfg, ref=REF_BIG_MEAN,
                                   tol=BIG_TOL,
                                   trace="predict_bigcloud_trace.json")
    rec["peak_mem_limit_gib"] = BIG_MEM_GIB
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"predict_bigcloud: metrics out of tolerance "
                             f"{rec}")
    if rec["peak_mem_gib"] >= BIG_MEM_GIB:
        raise AssertionError(f"predict_bigcloud peak {rec['peak_mem_gib']} "
                             f"GiB >= {BIG_MEM_GIB}")
    return rec, labels


TRAIN_SEED = 9            # the training clouds' stream (not EVAL_STREAM_SEED)
TRAIN_SHAPES = 4          # clouds in each of the two training sets
TRAIN_STEPS = 8           # two epochs of the two sets, mixed, in batches of 4
TRAIN_LOSS_RTOL = 1e-4    # the card's loss from the float64 step's
TRAIN_GRAD_RTOL = 1e-3    # per leaf, relative L2 from the float64 step (or
                          # twice the CPU float32 step's, where larger)
TRAIN_CKPT_TOL = 1e-6     # the forward of the re-read checkpoint
# the training path's launches in one step (one forward and its backward)
TRAIN_PER_STEP = {"K1": 3, "K2": 0, "K2b": 0, "K2 bf16": 0, "K2b bf16": 0,
                  "K3": 0, "K4": 0, "K5": 0, "K6": 3, "K6b": 3}


def train_cfg(preload):
    """configs/config_SEDNet_normal.yml, the production config (4 x 10000
    points, mode 5, k 64, embed 128, AdamW at lr 1e-4 and weight decay
    0.002, label smoothing 0.025, edge_topk 2000, ms_max_clusters 50), the
    inst model of checkpoints/bench_10k.npz preloaded; eval at the last
    step."""
    import dataclasses
    from sednet_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "config_SEDNet_normal.yml"))
    want = dict(batch_size=4, num_points=N_POINTS, mode=5, normals=True,
                knn=K, embed=128, optim="adamW", lr=1e-4, weight_decay=0.002,
                smooth=0.025, edge_topk=2000, ms_max_clusters=50)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"train: the production config changed: {got}")
    return dataclasses.replace(cfg, preload_model=True,
                               pretrain_model_path=preload, eval_T=10 ** 6)


def train_sets():
    """Synthetic training clouds from TRAIN_SEED in the port's array-backed
    datasets (the class under ParseNetDataset and EdgeDataset), train mode:
    a ParseNet set (no edge labels) and an edge set, mixed, and a test set
    of TRAIN_SHAPES clouds in eval mode."""
    import numpy as np
    from sednet_tpu_torch.data import MixedDataset, make_synthetic_shape
    from sednet_tpu_torch.data.datasets import _H5Dataset

    rng = np.random.RandomState(TRAIN_SEED)
    keys = ("points", "labels", "normals", "prim", "edges", "edges_w")

    def cloud_set(edges, **kw):
        raw = [make_synthetic_shape(rng, n_points=N_POINTS)
               for _ in range(TRAIN_SHAPES)]
        arr = [np.stack([d[k] for d in raw]) for k in keys]
        return _H5Dataset(*arr[:4], *(arr[4:] if edges else ()),
                          num_points=N_POINTS, **kw)

    mixed = MixedDataset(cloud_set(False, train=True),
                         cloud_set(True, train=True))
    return mixed, cloud_set(False, train=False)


def k6b_passes_ms(a, idx, order, mx, cot, calls=10):
    """Device ms of one K6b call, apart: the transpose (k6b_transpose_*
    and CUB's radix sort: every kernel of the call but the two passes,
    padding copies included, none at C = 64 or 128), pass 1 (k6b_sources)
    and pass 2 (k6b_rows), from `calls` calls under torch.profiler. Each
    part is its kernels' total over the launches the trace holds of its
    own first kernel (k6b_transpose_keys, k6b_sources, k6b_rows: one a
    call), so a trace that misses whole calls still gives one call's time;
    profiled again, up to three times, while it holds fewer than `calls`
    (`calls_traced`: each part's count in the trace kept; a part with none
    is None, not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sednet_tpu_torch.ops.graph import _gather_reduce_backward_launch

    def call():
        return _gather_reduce_backward_launch(a, idx, order, mx, *cot)

    parts = {"transpose_ms": "k6b_transpose_keys", "pass1_ms": "k6b_sources",
             "pass2_ms": "k6b_rows"}
    call()
    torch.cuda.synchronize()
    for _ in range(3):   # again while the trace misses some of the calls
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        seen = {part: sum(ev.count for ev in events if first in ev.key)
                for part, first in parts.items()}
        if min(seen.values()) == calls:
            break
    out = dict.fromkeys(parts, 0.0)
    for ev in events:
        part = ("pass1_ms" if "k6b_sources" in ev.key else
                "pass2_ms" if "k6b_rows" in ev.key else "transpose_ms")
        if seen[part]:
            out[part] += float(ev.self_device_time_total) / 1e3 / seen[part]
    for part, count in seen.items():   # not measured: no launch traced
        if not count:
            out[part] = None
    out["calls_traced"] = seen
    return out


# The C interface of the atomic K6b (PRs 9-12): a, idx, order, mx, gs, gsq,
# gmx, then B, N, C, K, then da and the stream, as its _build.py declares
# it in _SIGNATURES.
PARENT_K6B_SIGNATURE = ("_P",) * 7 + ("_I",) * 4 + ("_P", "_P")


def _declared_signature(root, name):
    """The argument types (their names in `_build.py`, e.g. "_P") that the
    tree at `root` declares for C entry point `name` in
    `sednet_tpu_torch/ops/_build.py`'s `_SIGNATURES`, or None."""
    import ast

    path = os.path.join(root, "sednet_tpu_torch", "ops", "_build.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "_SIGNATURES"
                        for t in node.targets)):
            for key, value in zip(node.value.keys, node.value.values):
                if getattr(key, "value", None) == name:
                    return tuple(getattr(e, "id", "?") for e in value.elts)
    return None


# The C interface of the bf16 mean-shift step: q, x, inv_b2, then B, N, E,
# then out and the stream.
PARENT_MS_BF16_SIGNATURE = ("_P",) * 3 + ("_I",) * 3 + ("_P", "_P")


# The C interface of K1 before its column-id table (PRs 1-15): q, p, the
# two batch strides, B, M, N, D, k, metric, w, largest, then the distances,
# the indices and the stream.
PARENT_TOPK_SIGNATURE = (("_P", "_P", "_L", "_L") + ("_I",) * 6
                         + ("_F", "_I", "_P", "_P", "_P"))


def parent_parts(root):
    """What the smoke can time of the tree at `root`: its K6b (`k6b`, the
    atomic kernel's interface only), its bf16 mean-shift step (`ms_bf16`)
    and its K1 without the column-id table (`topk`), each by the C
    interface its `_build.py` declares."""
    return {"k6b": _declared_signature(
                root, "sednet_gather_reduce_backward") == PARENT_K6B_SIGNATURE,
            "ms_bf16": _declared_signature(
                root, "sednet_mean_shift_step_bf16")
            == PARENT_MS_BF16_SIGNATURE,
            "topk": _declared_signature(root, "sednet_topk")
            == PARENT_TOPK_SIGNATURE}


def check_parent_tree(root):
    """Raise ValueError unless the tree at `root` declares one of the C
    interfaces the smoke binds (`parent_parts`)."""
    if not any(parent_parts(root).values()):
        raise ValueError(
            f"{root} declares none of the atomic K6b's "
            f"{PARENT_K6B_SIGNATURE}, the bf16 mean-shift step's "
            f"{PARENT_MS_BF16_SIGNATURE} and K1's {PARENT_TOPK_SIGNATURE}: "
            "nothing of it can be bound")


def _build_parent_source(root, name, lib_name):
    """csrc/`name` of the tree at `root` built alone with this tree's nvcc
    flags into build/<lib_name>/ (it includes the parent's own headers)."""
    from sednet_tpu_torch.ops import _build

    src = os.path.join(root, "sednet_tpu_torch", "csrc", name)
    out = os.path.join(ROOT, "build", lib_name, f"lib{lib_name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o",
                    out], check=True, capture_output=True, timeout=600)
    return out


def parent_ms_bf16(root):
    """The parent tree's bf16 mean-shift step (root: an older checkout,
    e.g. unpacked with `git archive` into build/parent): its
    csrc/mean_shift_bf16.cu built alone into build/ms_bf16_parent/ and
    bound by ctypes (`PARENT_MS_BF16_SIGNATURE`). Returns call(q, x,
    inv_b2, out) on bf16 (B, N, E) inputs at a kernel width, the launch
    alone."""
    import ctypes

    import torch

    if not parent_parts(root)["ms_bf16"]:
        raise ValueError(f"parent_ms_bf16: {root} declares no "
                         f"{PARENT_MS_BF16_SIGNATURE} bf16 step")
    path = _build_parent_source(root, "mean_shift_bf16.cu", "ms_bf16_parent")
    fn = ctypes.CDLL(path).sednet_mean_shift_step_bf16
    types = {"_P": ctypes.c_void_p, "_I": ctypes.c_int}
    fn.argtypes = [types[t] for t in PARENT_MS_BF16_SIGNATURE]
    fn.restype = ctypes.c_int

    def call(q, x, inv_b2, out):
        b, n, e = x.shape
        err = fn(q.data_ptr(), x.data_ptr(), inv_b2.data_ptr(), b, n, e,
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent bf16 mean-shift step: CUDA error {err}")
        return out

    return call


def parent_topk(root):
    """The parent tree's K1 without the column-id table (root: an older
    checkout): its csrc/flash_topk.cu built alone into build/topk_parent/
    and bound by ctypes (`PARENT_TOPK_SIGNATURE`). Returns call(q, p, k,
    largest) -> int32 indices, for 2-d or 3-d q and p (self or shared)."""
    import ctypes

    import torch

    if not parent_parts(root)["topk"]:
        raise ValueError(f"parent_topk: {root} declares no "
                         f"{PARENT_TOPK_SIGNATURE} K1")
    path = _build_parent_source(root, "flash_topk.cu", "topk_parent")
    fn = ctypes.CDLL(path).sednet_topk
    types = {"_P": ctypes.c_void_p, "_I": ctypes.c_int,
             "_L": ctypes.c_longlong, "_F": ctypes.c_float}
    fn.argtypes = [types[t] for t in PARENT_TOPK_SIGNATURE]
    fn.restype = ctypes.c_int

    def call(q, p, k, largest=False):
        q3 = q[None] if q.dim() == 2 else q
        b, m, d = q3.shape
        n = p.shape[-2]
        dist = torch.empty((b, m, k), device=q.device)
        idx = torch.empty((b, m, k), dtype=torch.int32, device=q.device)
        err = fn(q3.data_ptr(), p.data_ptr(), m * d,
                 0 if p.dim() == 2 else n * d, b, m, n, d, k, 0, 1.0,
                 int(largest), dist.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K1: CUDA error {err}")
        return idx

    return call


def parent_k6b(root):
    """The parent tree's K6b (root: an older checkout, e.g. unpacked with
    `git archive` into build/parent), the atomic kernel of PRs 9-12: its
    csrc/gather_reduce_bwd.cu built alone with this tree's nvcc flags into
    build/k6b_parent/ and bound by ctypes with that kernel's C interface
    (`PARENT_K6B_SIGNATURE`). A tree whose `_build.py` declares another
    signature is refused before anything is built. Returns call(a, idx,
    order, mx, cot) -> da, which zeroes da as the parent's wrapper did."""
    import ctypes

    import torch

    if not parent_parts(root)["k6b"]:
        raise ValueError(f"parent_k6b: {root} declares no atomic K6b "
                         f"{PARENT_K6B_SIGNATURE}")
    out = _build_parent_source(root, "gather_reduce_bwd.cu", "k6b_parent")
    fn = ctypes.CDLL(out).sednet_gather_reduce_backward
    types = {"_P": ctypes.c_void_p, "_I": ctypes.c_int}
    fn.argtypes = [types[t] for t in PARENT_K6B_SIGNATURE]
    fn.restype = ctypes.c_int

    def call(a, idx, order, mx, cot):
        b, n, c = a.shape
        da = torch.zeros_like(a)
        err = fn(a.data_ptr(), idx.data_ptr(),
                 0 if order is None else order.data_ptr(), mx.data_ptr(),
                 *(t.data_ptr() for t in cot), b, n, c, idx.shape[2],
                 da.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K6b: CUDA error {err}")
        return da

    return call


def check_gather_reduce_backward(name, a, idx, order, gen, parent=None):
    """K6b against gather_reduce_backward_plain on one layer's signed table,
    graph and forward max, with cotangents drawn from `gen`: every element
    within backward_error_bound of the plain version on the card; three
    launches with the same bits; on the first cloud, the CPU plain
    version's bits on every row. Recorded: the in-degree's max, 99th
    percentile and mean. Timed: K6b (one call, and its device time
    split into the transpose, pass 1 and pass 2), the plain version, and
    index_add_ of the precomputed (B N K, C) terms into (B N, C), the
    nearest library call, which does less (no gather, no tie count); and,
    given `parent` (`parent_k6b`), the parent tree's K6b on the same
    inputs. The bound counts a, mx, gs, gsq, gmx, the int64 graph and the
    order read once and da written once, and 6 operations a gathered value
    (a compare and an add counting ties; two products and two adds forming
    and adding the term)."""
    import torch
    from sednet_tpu_torch.ops.graph import (backward_error_bound,
                                            gather_neighbors,
                                            gather_reduce_backward,
                                            gather_reduce_backward_plain,
                                            gather_reduce_plain,
                                            graph_transpose)

    b, n, c = a.shape
    k = idx.shape[-1]
    mx = gather_reduce_plain(a, idx)[2]
    cot = [torch.randn((b, n, c), generator=gen).to(a.device)
           for _ in range(3)]
    da = gather_reduce_backward(a, idx, mx, *cot, order=order)
    plain = gather_reduce_backward_plain(a, idx, mx, *cot)
    bound = backward_error_bound(a, idx, mx, *cot)
    torch.cuda.synchronize()
    err = (da.double() - plain.double()).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"K6b {name}: {float(err.max())} above the "
                             f"rounding bound (max {float(bound.max())})")
    same = all(torch.equal(gather_reduce_backward(a, idx, mx, *cot,
                                                  order=order), da)
               for _ in range(2))
    if not same:
        raise AssertionError(f"K6b {name}: three launches, other bits")
    ends = graph_transpose(idx, n)[0]
    deg = torch.diff(ends, prepend=ends.new_zeros(1))
    got = da[:1].cpu()
    want = gather_reduce_backward_plain(
        *(t[:1].cpu() for t in (a, idx, mx, *cot)))
    bits = {"rows": n, "equal_cpu_plain": torch.equal(got, want),
            "rows_differing": int((got != want).any(-1).sum())}
    if not bits["equal_cpu_plain"]:
        raise AssertionError(f"K6b {name}: the first cloud against the "
                             f"CPU's plain version {bits}")
    g = gather_neighbors(a, idx)
    tie = g == mx[:, :, None, :]
    cnt = tie.sum(2, dtype=a.dtype)
    terms = (cot[0][:, :, None] + 2.0 * g * cot[1][:, :, None]
             + torch.where(tie, (cot[2] / cnt.clamp_min(1.0))[:, :, None],
                           0.0)).reshape(-1, c)
    flat = (idx.clamp(0, n - 1) + n * torch.arange(
        b, device=a.device)[:, None, None]).reshape(-1)
    del g, tie
    bms, by = bound_ms(6 * b * n * k * c,
                       4 * 6 * b * n * c + 8 * idx.numel() + 4 * b * n)
    degf = deg.double()
    out = {"case": name, "shape": [b, n, k, c],
           "max_abs_err": float(err.max()),
           "max_err_over_bound": float((err / bound.clamp_min(1e-30)).max()),
           "same_bits_3_launches": same, "first_cloud_bits": bits,
           "in_degree": {"max": int(deg.max()),
                         "p99": float(torch.quantile(degf, 0.99)),
                         "mean": float(degf.mean())},
           "ms": time_ms(lambda: gather_reduce_backward(a, idx, mx, *cot,
                                                        order=order), reps=20),
           "device_ms": burst_ms(lambda: gather_reduce_backward(
               a, idx, mx, *cot, order=order)),
           "device_split": k6b_passes_ms(a, idx, order, mx, cot),
           "plain_ms": time_ms(lambda: gather_reduce_backward_plain(
               a, idx, mx, *cot), reps=5),
           "library_ms": time_ms(lambda: torch.zeros(
               (b * n, c), device=a.device).index_add_(0, flat, terms),
               reps=10),
           "library": "index_add_ of the precomputed terms (less work)",
           "bound_ms": bms, "bound_by": by}
    if parent is not None:
        old = parent(a, idx, order, mx, cot)
        out["parent"] = {
            "ms": time_ms(lambda: parent(a, idx, order, mx, cot), reps=20),
            "device_ms": burst_ms(lambda: parent(a, idx, order, mx, cot)),
            "max_abs_diff": float((old - da).abs().max())}
    del terms, flat
    return out


class _Graphs:
    """Inside `with`, the encoder's kNN graphs (`models.backbone`'s
    knn_indices and knn_indices_points_normals) are recorded in call
    order, or, given `replay`, replaced by those recorded graphs."""

    def __init__(self, replay=None):
        self.graphs, self.replay = [], replay

    def __enter__(self):
        from sednet_tpu_torch.models import backbone

        self.saved = (backbone.knn_indices, backbone.knn_indices_points_normals)

        def wrap(fn):
            def call(x, *args, **kw):
                self.graphs.append(
                    fn(x, *args, **kw) if self.replay is None
                    else self.replay[len(self.graphs)].to(x.device))
                return self.graphs[-1]
            return call

        backbone.knn_indices, backbone.knn_indices_points_normals = map(
            wrap, self.saved)
        return self

    def __exit__(self, *exc):
        from sednet_tpu_torch.models import backbone

        backbone.knn_indices, backbone.knn_indices_points_normals = self.saved


class _Maxima:
    """Inside `with`, the maxima of the edge convolutions' gather-reduces
    (`ops.graph.gather_reduce`, kernel K6, which `models.backbone`'s edge
    convolutions reach through `edge_conv_factored`) are recorded in call
    order, each as the mask (B, N, K, C) of the neighbours equal to their
    row's max in a channel (the winner and its ties), with the table the
    max read. Recording raises unless K6's max is the max of the gathered
    values in every (row, channel). Given `replay`, those masks are taken
    in place of this side's own: the max becomes the mean of the recorded
    winners' values (the max itself where the two sides agree), whose
    gradient splits the max's cotangent over them as the max's own does.
    For each call, `flips` counts the (row, channel) pairs whose own
    winners differ from the replayed ones, and raises unless each is a
    near-tie: this side's gap from its own max to the best of the replayed
    winners is at most twice the largest difference between the two sides'
    values over that row's neighbours in that channel (`flip_gaps` keeps
    the largest gap and the largest such bound). The replay runs the plain
    gather, so it is for the CPU."""

    def __init__(self, replay=None):
        self.masks, self.tables, self.replay = [], [], replay
        self.flips, self.flip_gaps = [], []

    def __enter__(self):
        import torch
        from sednet_tpu_torch.ops import graph

        self.saved = graph.gather_reduce

        def call(a, idx, order=None):
            if self.replay is None:
                s, sq, mx = self.saved(a, idx, order)
                g = graph.gather_neighbors(a.detach(), idx)
                if not torch.equal(g.amax(2), mx.detach()):
                    raise AssertionError(
                        f"train: K6's max is not its row's max in call "
                        f"{len(self.masks)}")
                self.masks.append((g == mx.detach()[:, :, None, :]).cpu())
                self.tables.append(a.detach().float().cpu())
                return s, sq, mx
            g = graph.gather_neighbors(a, idx)
            call_no = len(self.masks)
            mask = self.replay["masks"][call_no].to(a.device)
            self.masks.append(mask)
            gd = g.detach()
            own = gd == gd.amax(2, keepdim=True)
            flip = (own != mask).any(2)
            self.flips.append(int(flip.sum()))
            if self.flips[-1]:
                b, n, c = flip.nonzero(as_tuple=True)
                mine = gd[b, n, :, c]                        # (F, K)
                theirs = graph.gather_neighbors(
                    self.replay["tables"][call_no].to(gd), idx)[b, n, :, c]
                won = torch.where(mask[b, n, :, c], mine, -torch.inf)
                gap = mine.amax(1) - won.amax(1)
                bound = 2.0 * (mine - theirs).abs().amax(1)
                self.flip_gaps.append({"gap": float(gap.max()),
                                       "bound": float(bound.max())})
                if bool((gap > bound).any()):
                    raise AssertionError(
                        f"train: call {call_no}: "
                        f"{int((gap > bound).sum())} of {self.flips[-1]} max "
                        f"flips are no near-tie (largest gap "
                        f"{float(gap.max())}, bound {float(bound.max())})")
            cnt = mask.sum(2, dtype=a.dtype)
            return (g.sum(2), (g * g).sum(2),
                    torch.where(mask, g, 0.0).sum(2) / cnt)

        # K6's wrapper counts its launches on the function of that name
        call.launches = self.saved.launches
        graph.gather_reduce = call
        return self

    def __exit__(self, *exc):
        from sednet_tpu_torch.ops import graph

        self.saved.launches = graph.gather_reduce.launches
        graph.gather_reduce = self.saved


class _DirectMaxima:
    """`_Maxima` for the direct edge convolution (`factored_gn` off, or a
    bf16 model: `models.backbone.edge_conv_direct`), whose max over the K
    neighbours of leaky_relu(GroupNorm(f)) is a discrete choice too:
    recorded on one side as the mask (B, N, K, C) of each (row, channel)'s
    winners with the values they won among, replayed on the other as the
    mean of the recorded winners' values, with the same near-tie rule for
    the (row, channel) pairs whose own winners differ (`flips`,
    `flip_gaps`)."""

    def __init__(self, replay=None):
        self.masks, self.tables, self.replay = [], [], replay
        self.flips, self.flip_gaps = [], []

    def __enter__(self):
        import torch
        from sednet_tpu_torch.models import backbone
        from sednet_tpu_torch.ops.graph import edge_conv_features

        self.saved = backbone.edge_conv_direct

        def call(x, idx, weight, scale, bias, *, groups, negative_slope=0.2,
                 dtype=torch.float32):
            f = edge_conv_features(x.to(dtype), idx, weight.to(dtype))
            y = backbone.leaky_relu(backbone.group_norm(f, groups, scale,
                                                        bias), negative_slope)
            yd = y.detach()
            if self.replay is None:
                mx = y.amax(2)
                self.masks.append((yd == mx.detach()[:, :, None]).cpu())
                self.tables.append(yd.float().cpu())
                return mx
            call_no = len(self.masks)
            mask = self.replay["masks"][call_no].to(y.device)
            self.masks.append(mask)
            flip = ((yd == yd.amax(2, keepdim=True)) != mask).any(2)
            self.flips.append(int(flip.sum()))
            if self.flips[-1]:
                b, n, c = flip.nonzero(as_tuple=True)
                mine = yd[b, n, :, c].double()
                theirs = self.replay["tables"][call_no].to(y.device)[
                    b, n, :, c].double()
                won = torch.where(mask[b, n, :, c], mine, -torch.inf)
                gap = mine.amax(1) - won.amax(1)
                bound = 2.0 * (mine - theirs).abs().amax(1)
                self.flip_gaps.append({"gap": float(gap.max()),
                                       "bound": float(bound.max())})
                if bool((gap > bound).any()):
                    raise AssertionError(
                        f"direct edge conv: call {call_no}: "
                        f"{int((gap > bound).sum())} of {self.flips[-1]} max "
                        f"flips are no near-tie")
            # the mean in float32 or wider: a bf16 sum of tied winners
            # rounds, so that their mean would no longer be their value
            acc = torch.promote_types(y.dtype, torch.float32)
            cnt = mask.sum(2, dtype=acc)
            return (torch.where(mask, y, 0.0).to(acc).sum(2) / cnt).to(
                y.dtype)

        backbone.edge_conv_direct = call
        return self

    def __exit__(self, *exc):
        from sednet_tpu_torch.models import backbone

        backbone.edge_conv_direct = self.saved


def _computes_in(m, dtype):
    """m with every layer computing in dtype (the attribute `dtype` of the
    model, its encoder and edge convolutions)."""
    for mod in m.modules():
        if hasattr(mod, "factored_gn") or hasattr(mod, "sort_points") \
                or hasattr(mod, "w_pos_enc"):
            mod.dtype = dtype
    return m


def card_vs_cpu_step(model, cfg, batch, own_graphs=False):
    """One step's loss and gradients for the first cloud of `batch` on the
    card (K1, K6, K6b) and on the CPU in float32 and in float64, from the
    same parameters and the same triplet draws, the CPU on the card's
    discrete choices: its three kNN graphs (`_Graphs`) and, in each edge
    convolution, the neighbours that win each row's max (`_Maxima`, which
    also holds K6's max to the max of its gathered values). So the sides
    differ by their arithmetic alone; where a max is a near-tie, the card's
    rounding and the CPU's may pick different neighbours, which moves the
    max's cotangent to another row (`max_flips`: the CPU float32 side's own
    winners against the card's, each held to be a near-tie, see
    `_Maxima`). The loss is held to the float64 step's within
    TRAIN_LOSS_RTOL; each gradient leaf within TRAIN_GRAD_RTOL, or within
    twice the CPU float32 step's own distance from it where that is
    larger, the rule of `e2e_card_vs_cpu` (either float32 side can be the
    one far from float64). With own_graphs
    (`scripts/probe_train_check.py`), printed beside it: the CPU step on
    its own graphs and maxima (the plain top-k), where K1's TF32 split
    swaps near-tie neighbours in a few rows; and the rows of each graph
    whose neighbour set differs between the two.

    A model with the direct edge convolution (`factored_gn` off, or bf16
    compute) replays its maxima through `_DirectMaxima`, and its float64
    step computes every layer in float64. A bf16 model's CPU step runs in
    bf16 as the card's does, and its loss is held like its gradients:
    within TRAIN_LOSS_RTOL of float64's, or twice the CPU bf16 step's own
    distance where that is larger."""
    import copy

    import torch
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.losses import TripletConfig
    from sednet_tpu_torch.losses.embedding import sample_draws

    one = {k: v[:1].cpu() for k, v in batch.items()}
    draws = sample_draws(one["labels"], TripletConfig(
        margin=cfg.triplet_margin, max_segments=cfg.ms_max_clusters),
        torch.Generator().manual_seed(TRAIN_SEED))

    direct = model.dtype != torch.float32 or not all(
        c.factored_gn for c in (model.encoder.conv1, model.encoder.conv2,
                                model.encoder.conv3))

    def run(dev, replay=None, dtype=torch.float32):
        m = copy.deepcopy(model).to(dev).to(dtype)
        if direct and dtype == torch.float64:
            _computes_in(m, dtype)
        m.zero_grad(set_to_none=True)
        seen = {}   # the encoder's features and its global max's argmax
        hooks = [m.encoder.register_forward_hook(
                     lambda mod, i, o: seen.update(feats=o[1].detach().cpu())),
                 m.encoder.gn_mlp1.register_forward_hook(
                     lambda mod, i, o: seen.update(
                         argmax=o.detach().relu().argmax(1).cpu()))]
        b = {k: v.to(dev, dtype if v.is_floating_point() else v.dtype)
             for k, v in one.items()}
        maxima_of = _DirectMaxima if direct else _Maxima
        with _Graphs(replay and replay["graphs"]) as graphs, \
                maxima_of(replay and replay["maxima"]) as maxima:
            total, _ = T.make_loss_fn(m, cfg)(b, draws)
            total.backward()
        for h in hooks:
            h.remove()
        grads = {k: p.grad.detach().cpu().double()
                 for k, p in m.named_parameters()}
        return {"loss": float(total.detach()), "grads": grads,
                "graphs": [g.cpu() for g in graphs.graphs],
                "maxima": {"masks": maxima.masks, "tables": maxima.tables},
                "flips": maxima.flips, "flip_gaps": maxima.flip_gaps,
                "seen": seen}

    def rel(a, b):
        return {k: float((a["grads"][k] - b["grads"][k]).norm()
                         / b["grads"][k].norm().clamp_min(1e-30))
                for k in b["grads"]}

    def versus(card, cpu):
        vs = rel(card, cpu)
        worst = max(vs, key=vs.get)
        return {"loss_rel_err": abs(card["loss"] - cpu["loss"])
                / abs(cpu["loss"]),
                "grad_rel_err_max": vs[worst], "grad_worst_leaf": worst,
                "grad_rel_err_median": sorted(vs.values())[len(vs) // 2],
                "feats_max_abs_diff": float(
                    (card["seen"]["feats"] - cpu["seen"]["feats"]).abs().max()),
                "global_max_argmax_flips": int(
                    (card["seen"]["argmax"] != cpu["seen"]["argmax"]).sum())}

    card = run(DEVICE)
    cpu = run("cpu", replay=card)
    exact = run("cpu", replay=card, dtype=torch.float64)
    card_f64, cpu_f64 = rel(card, exact), rel(cpu, exact)
    allowed = {k: max(TRAIN_GRAD_RTOL, 2.0 * cpu_f64[k]) for k in card_f64}
    over = {k: (card_f64[k], allowed[k]) for k in card_f64
            if card_f64[k] > allowed[k]}
    worst = sorted(card_f64, key=lambda k: card_f64[k] / allowed[k])[-3:]
    loss_f64 = {name: abs(side["loss"] - exact["loss"]) / abs(exact["loss"])
                for name, side in (("card", card), ("cpu_f32", cpu))}
    loss_allowed = (TRAIN_LOSS_RTOL if model.dtype == torch.float32
                    else max(TRAIN_LOSS_RTOL, 2.0 * loss_f64["cpu_f32"]))
    rec = {"loss": card["loss"], "cpu_loss": cpu["loss"],
           "f64_loss": exact["loss"], "loss_vs_f64": loss_f64,
           "loss_allowed": loss_allowed, **versus(card, cpu),
           "max_flips": cpu["flips"], "max_flips_f64": exact["flips"],
           "flip_gaps": cpu["flip_gaps"], "flip_gaps_f64": exact["flip_gaps"],
           "card_vs_f64_max": max(card_f64.values()),
           "cpu_f32_vs_f64_max": max(cpu_f64.values()),
           "worst_vs_f64": {k: {"card": card_f64[k], "cpu_f32": cpu_f64[k],
                                "allowed": allowed[k]} for k in worst},
           "over_allowed": over}
    if own_graphs:
        own = run("cpu")
        rec["cpu_own_graphs"] = {
            **versus(card, own),
            "graph_rows_differing": [
                int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(card["graphs"], own["graphs"])]}
    if loss_f64["card"] > loss_allowed or over:
        raise AssertionError(f"train: the card's step against the CPU's {rec}")
    return rec


def repeated_step_bits(model, cfg, batch):
    """One step's gradient computed twice from the same parameters, batch
    and triplet draws (forward, losses, backward): the gradient leaves
    whose bits differ between the two. Recorded, not held: K6b is
    deterministic, other kernels of the step may not be."""
    import torch
    from sednet_tpu_torch import train as T

    loss_fn = T.make_loss_fn(model, cfg)
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(batch, generator=torch.Generator().manual_seed(
            TRAIN_SEED))
        total.backward()
        grads.append({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
    model.zero_grad(set_to_none=True)
    differ = sorted(k for k in grads[0]
                    if not torch.equal(grads[0][k], grads[1][k]))
    return {"leaves": len(grads[0]), "same_bits": not differ,
            "leaves_differing": differ,
            "max_abs_diff": max((float((grads[0][k] - grads[1][k]).abs().max())
                                 for k in differ), default=0.0)}


def phase_train(models, card):
    """The trainer's loop (`train.train_loader`, which `train.train` runs over
    h5 sets; this phase needs no h5py) under the production config, the
    inst model preloaded, over the mixed synthetic training sets for
    TRAIN_STEPS steps and one eval, checkpoints into build/train_smoke/.
    Held to: every step's loss finite; the launches of the loop (K1 and K6
    three a forward, K6b three a backward); one step's launches; K6b within
    its rounding bound of its plain version at the three layer shapes on
    the batch's real graphs; the card's step against the CPU's for one
    cloud; the checkpoint re-read giving the same forward. Timed: the loop,
    and train steps on one batch (median after warm-up)."""
    import logging
    import shutil

    import torch
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.data import BatchLoader, PrefetchLoader
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.graph import locality_order
    from sednet_tpu_torch.weights import load_checkpoint, save_params_npz

    root = os.path.join(ROOT, "build", "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "run"))
    preload = os.path.join(root, "preload_inst.npz")
    save_params_npz(preload, models["inst"])
    cfg = train_cfg(preload)
    t0 = time.time()
    mixed, test_ds = train_sets()
    data_s = time.time() - t0
    model, optimizer, gen = T.init_training(cfg, DEVICE)
    loader = PrefetchLoader(BatchLoader(mixed, cfg.batch_size, shuffle=True,
                                        seed=cfg.seed))
    test_loader = BatchLoader(test_ds, cfg.batch_size, shuffle=False)

    losses = []

    class StepLosses(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("epoch"):
                losses.append(record.args[2]["loss"])

    log = logging.getLogger("sednet_tpu_torch.train")
    handler = StepLosses()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.time()
    try:
        state, history = T.train_loader(
            cfg, model, loader, test_loader, optimizer=optimizer,
            run_dir=os.path.join(root, "run"), max_steps=TRAIN_STEPS,
            log_every=1, generator=gen)
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    loop_s = time.time() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # what the loop itself added, above what earlier phases hold
    peak_above_start_gib = peak_gib - start_bytes / 2 ** 30
    n_eval = len(test_loader)
    want = {key: n * (TRAIN_STEPS + (n_eval if key != "K6b" else 0))
            for key, n in TRAIN_PER_STEP.items()}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    if (len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses))
            or len(history) != 1):
        raise AssertionError(f"train: step losses {losses}, history "
                             f"{history}")

    t0 = time.time()
    batch = T.to_device(next(iter(BatchLoader(mixed, cfg.batch_size,
                                              shuffle=False))), DEVICE)
    batch_s = time.time() - t0
    x = T.model_input(batch, cfg.normals).contiguous()
    # the last checkpoint, written at the eval after the last step, re-read
    ckpt = os.path.join(root, "run", "ckpts", "latest.npz")
    reread = load_checkpoint(ckpt, cfg, DEVICE)
    with torch.no_grad():
        a, b = model(x), reread(x)
    ckpt_diff = max(float((getattr(a, f) - getattr(b, f)).abs().max())
                    for f in ("embedding", "type_log_prob", "edge_logits"))
    if ckpt_diff > TRAIN_CKPT_TOL:
        raise AssertionError(f"train: re-read checkpoint's forward {ckpt_diff}"
                             " from the trained model's")

    t0 = time.time()
    save_params_npz(os.path.join(root, "timed.npz"), model)
    save_s = time.time() - t0

    step = T.make_train_step(model, optimizer, cfg)
    reset_counts()
    step(batch, generator=gen)
    torch.cuda.synchronize()
    per_step = read_counts()
    if per_step != TRAIN_PER_STEP:
        raise AssertionError(f"train: one step's launches {per_step}")
    step_ms = time_ms(lambda: step(batch, generator=gen), reps=5, warmup=1)
    # where a step's time goes: the forward and losses, the backward, the
    # optimizer's update (differences of medians), and one step profiled
    loss_fn = T.make_loss_fn(model, cfg)
    split = {"forward_loss_ms": time_ms(lambda: loss_fn(batch, generator=gen),
                                        reps=5, warmup=1),
             "forward_loss_backward_ms": time_ms(
                 lambda: loss_fn(batch, generator=gen)[0].backward(),
                 reps=5, warmup=1)}
    split["backward_ms"] = (split["forward_loss_backward_ms"]
                            - split["forward_loss_ms"])
    split["optimizer_ms"] = step_ms - split["forward_loss_backward_ms"]
    prof = _device_profile(lambda: step(batch, generator=gen),
                           "train_step_trace.json")
    prof.pop("stages")
    # K6b's own kernels in the profiled step (its transpose's CUB sort and
    # scan aside, whose names it shares with other sorts)
    prof["k6b_kernels_ms"] = _kernel_share(
        os.path.join(ROOT, "build", "train_step_trace.json"), "k6b_")[0]

    order = locality_order(x[..., :3].contiguous())
    cot_gen = torch.Generator().manual_seed(TRAIN_SEED)
    parent = (parent_k6b(PARENT_TREE)
              if PARENT_TREE and parent_parts(PARENT_TREE)["k6b"] else None)
    k6b = [check_gather_reduce_backward(
        name, a, flash_topk(g, g, K, metric=metric), order, cot_gen, parent)
        for name, g, a, metric in _fused_layer_inputs(model, x)]
    try:
        versus_cpu, failure = card_vs_cpu_step(model, cfg, batch), None
    except AssertionError as exc:   # emitted with the record, then raised
        versus_cpu, failure = {"failed": str(exc)}, exc
    repeat = repeated_step_bits(model, cfg, batch)

    rec = {"phase": "train", "ok": failure is None, "card": card,
           "config": "configs/config_SEDNet_normal.yml",
           "batch": [cfg.batch_size, cfg.num_points], "k": cfg.knn,
           "steps": TRAIN_STEPS, "step_losses": losses,
           "history": history, "launches": counts,
           "launches_per_step": per_step,
           "step_ms": step_ms, "shapes_per_s": cfg.batch_size * 1e3 / step_ms,
           "step_split": split, "step_profile": prof,
           "loop_s": loop_s, "loop_step_s_with_eval": loop_s / TRAIN_STEPS,
           "data_setup_s": data_s, "batch_on_host_s": batch_s,
           "save_npz_s": save_s, "peak_gib": peak_gib,
           "peak_above_start_gib": peak_above_start_gib,
           "k6b": k6b, "card_vs_cpu": versus_cpu,
           "repeated_step_bits": repeat,
           "checkpoint": os.path.relpath(ckpt, ROOT),
           "checkpoint_forward_max_diff": ckpt_diff}
    emit(rec)
    if failure is not None:
        raise failure
    del model, optimizer, reread, state
    torch.cuda.empty_cache()
    return counts, k6b


SERVE_SHORT = 7000        # the short cloud of the npz request
SERVE_NEAR_TIE = 1e-5     # rows whose top two logits lie closer are exempt
SERVE_READY_S = 300       # the server's start-up, at most
SERVE_KERNELS = ("K1", "K2", "K3", "K6")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(method, url, body=None, content_type="application/json"):
    """One request: (status, parsed JSON, ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": content_type})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, blob = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, blob = e.code, e.read()
    return code, json.loads(blob), (time.time() - t0) * 1e3


def _start_server(bundle, port, log_path):
    """`python -m sednet_tpu_torch.serve <bundle> --cluster --port <port>`
    in a process of its own (stdout and stderr into log_path); returns
    (process, seconds until it printed its "serving" line)."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    log = open(log_path, "w")
    t0 = time.time()
    cmd = [sys.executable, "-m", "sednet_tpu_torch.serve", bundle,
           "--cluster", "--port", str(port)]
    if DEVICE != "cuda":   # a rehearsal on the CPU
        cmd += ["--device", DEVICE]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    while time.time() - t0 < SERVE_READY_S:
        with open(log_path) as f:
            if '"serving"' in f.read():
                return proc, time.time() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    proc.wait()
    with open(log_path) as f:
        raise AssertionError(f"serve: the server did not start:\n{f.read()}")


def _argmax_bad_rows(got, logits):
    """Rows of got (n,) that differ from the argmax of logits (n, C)
    outside near-ties (top two within SERVE_NEAR_TIE), and the tied rows."""
    import numpy as np

    top2 = np.sort(logits, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > SERVE_NEAR_TIE
    bad = (np.asarray(got) != logits.argmax(-1)) & sure
    return int(bad.sum()), int((~sure).sum())


def phase_serve(models, x_np):
    """The serving path: both models of checkpoints/bench_10k.npz exported
    (`export.export_serving_bundle`, their state dicts) at the eval's
    shape, 8 x 10000 x 6, under bench.py's config 2 with its clustering
    knobs (`predict_cfg`: k 64, embed 128, HPNet enrichment, 5000
    samples), on the card, into build/serve_bundle/; then `python -m
    sednet_tpu_torch.serve <bundle> --cluster` in a process of its own,
    which builds no model, and four requests to it: the 8 eval clouds as
    JSON, 3 of them as npz (one cut to SERVE_SHORT points, through the
    npz's "lengths"), GET /health, and a malformed body. Held to: 200 for
    each but the malformed (400); types and edges equal to the argmax of
    `predict.forward` on the same padded input outside near-ties;
    instance labels equal to the port's own enrichment and
    `guard_mean_shift` on the bundle's embedding (loaded in this process)
    with the server's generators (`serve.request_generators` from seed 0,
    one draw a clustered request); K1, K2, K3 and K6 launched inside the
    server (the counts it logs on /health). Reported: export s, the
    server's start-up s, bundle MB, each request's ms, and the device busy
    share of one clustered 8-cloud request in this process."""
    import io
    import shutil

    import numpy as np
    import torch
    from torch.profiler import record_function
    from sednet_tpu_torch import export, serve
    from sednet_tpu_torch.cluster.mean_shift import guard_mean_shift
    from sednet_tpu_torch.cluster.spectral import hpnet_process
    from sednet_tpu_torch.predict import STAGES as PREDICT_STAGES
    from sednet_tpu_torch.predict import forward, spectral_embed

    root = os.path.join(ROOT, "build", "serve_smoke")
    bundle = os.path.join(root, "bundle")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = predict_cfg(batch_size=BATCH)
    t0 = time.time()
    export.export_serving_bundle(cfg, models["type"].state_dict(),
                                 models["inst"].state_dict(), bundle,
                                 device=DEVICE)
    torch.cuda.synchronize()
    export_s = time.time() - t0
    bundle_mb = sum(os.path.getsize(os.path.join(bundle, f))
                    for f in os.listdir(bundle)) / 2 ** 20

    rng = np.random.RandomState(SERVE_SHORT)
    keep = np.sort(rng.permutation(N_POINTS)[:SERVE_SHORT])
    three = [x_np[0], x_np[1][keep], x_np[2]]
    buf = io.BytesIO()
    tail = np.zeros((N_POINTS - SERVE_SHORT, 6), np.float32)  # cut off
    np.savez(buf, points=np.stack([x_np[0], np.concatenate([three[1], tail]),
                                   x_np[2]]),
             lengths=np.array([N_POINTS, SERVE_SHORT, N_POINTS]))
    requests = [
        ("predict_json_8", "POST", "/predict",
         json.dumps({"points": x_np.tolist()}).encode(), "application/json"),
        ("predict_npz_3", "POST", "/predict", buf.getvalue(),
         "application/x-npz"),
        ("health", "GET", "/health", None, "application/json"),
        ("malformed", "POST", "/predict", b'{"points": [[1, 2', 
         "application/json")]
    port = _free_port()
    log_path = os.path.join(root, "server.log")
    proc, ready_s = _start_server(bundle, port, log_path)
    replies = {}
    try:
        for name, method, path, body, ctype in requests:
            replies[name] = _http(method, f"http://127.0.0.1:{port}{path}",
                                  body, ctype)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    codes = {name: r[0] for name, r in replies.items()}
    want_codes = {"predict_json_8": 200, "predict_npz_3": 200, "health": 200,
                  "malformed": 400}
    with open(log_path) as f:
        log = f.read()
    if codes != want_codes:
        raise AssertionError(f"serve: status codes {codes}\n{log[-4000:]}")
    health = [json.loads(ln) for ln in log.splitlines()
              if ln.startswith('{"health"')]
    server_launches = health[-1]["launches"] if health else {}
    if any(server_launches.get(k, 0) <= 0 for k in SERVE_KERNELS):
        raise AssertionError(f"serve: the server's launches {server_launches}")

    # the same requests in this process: the bundle's embedding, the port's
    # own clustering of it, the forward's types and edges
    srv = serve.BundleServer(bundle, device=DEVICE)
    gen = torch.Generator().manual_seed(0)   # the server's seed
    checks = []
    for name, shapes in (("predict_json_8", list(x_np)),
                         ("predict_npz_3", three)):
        got = replies[name][1]["results"]
        if len(got) != len(shapes):
            raise AssertionError(f"serve: {name} answered {len(got)} shapes")
        x_pad, lengths = srv._pad(shapes)
        xt = torch.from_numpy(x_pad).to(DEVICE)
        _, type_lp, edge_logits = forward(models["type"], xt)
        with torch.no_grad():
            emb = srv.fns["inst_model"](xt)["embedding"]
        gens = serve.request_generators(gen, len(shapes))
        for i, n in enumerate(lengths):
            bad_t, tie_t = _argmax_bad_rows(got[i]["types"],
                                            type_lp[i, :n].cpu().numpy())
            bad_e, tie_e = _argmax_bad_rows(got[i]["edges"],
                                            edge_logits[i, :n].cpu().numpy())
            e = emb[i, :n]
            xyz, nrm = xt[i, :n, :3], xt[i, :n, 3:6]
            v, ent = spectral_embed(xyz, nrm, cfg, generator=gens[i])
            e = hpnet_process(e, xyz, nrm, normal_smooth_w=cfg.normal_smooth_w,
                              cached_eigvecs=v, cached_eig_entropy=ent)
            e = e / torch.clamp_min(e.norm(dim=-1, keepdim=True), 1e-12)
            own = guard_mean_shift(
                e, num_samples=min(cfg.ms_num_samples, n),
                quantile=cfg.ms_quantile, iterations=cfg.ms_iterations,
                max_clusters=cfg.ms_max_clusters - 1,
                retry_factor=cfg.ms_retry_factor, tol=cfg.ms_tol,
                generator=gens[i])
            checks.append({
                "request": name, "shape": i, "points": n,
                "type_bad_rows": bad_t, "type_near_ties": tie_t,
                "edge_bad_rows": bad_e, "edge_near_ties": tie_e,
                "instances_equal": got[i]["instances"] == own.labels.tolist(),
                "num_instances": got[i]["num_instances"],
                "own_num_instances": own.num_clusters})
    bad = [c for c in checks if c["type_bad_rows"] or c["edge_bad_rows"]
           or not c["instances_equal"]]
    lengths_ok = [len(r["types"]) for r in replies["predict_npz_3"][1][
        "results"]] == [N_POINTS, SERVE_SHORT, N_POINTS]

    csrv = serve.BundleServer(bundle, cluster=True, device=DEVICE)
    csrv.predict(list(x_np))   # warm

    def one_request():
        with record_function("serve/predict"):
            csrv.predict(list(x_np))

    # the request's range and the predict stages inside spectral_embed are
    # ranges, not kernels
    prof = _device_profile(one_request, "serve_trace.json",
                           stages=("serve/predict",) + PREDICT_STAGES)
    rec = {"phase": "serve", "ok": not bad and lengths_ok,
           "bundle": os.path.relpath(bundle, ROOT),
           "bundle_shape": [BATCH, N_POINTS, 6], "export_s": export_s,
           "server_ready_s": ready_s, "bundle_mb": bundle_mb,
           "request_ms": {name: r[2] for name, r in replies.items()},
           "status": codes, "server_launches": server_launches,
           "launches_read_from": "the server's /health log line",
           "malformed_error": replies["malformed"][1].get("error"),
           "checks": checks, "npz_lengths_ok": lengths_ok,
           "clustered_request_profile": {
               k: prof[k] for k in ("wall_s", "device_kernel_s",
                                    "device_busy_share", "top", "stages")},
           "busy_share_of": "one clustered 8-cloud BundleServer.predict "
                            "in this process, under torch.profiler"}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve: {bad}, npz lengths {lengths_ok}")
    del srv, csrv
    torch.cuda.empty_cache()
    return server_launches


E2E_SEED = 12             # the e2e clouds' stream (not EVAL_STREAM_SEED)
E2E_SHAPES = 4
E2E_STEPS = 3
E2E_LOSS_RTOL = 1e-4      # step 1's loss, card against CPU, same inputs
E2E_GRAD_RTOL = 1e-3      # per leaf, relative L2 (see e2e_card_vs_cpu)
# one e2e step's launches: two forwards (phase A's and the step's), 5
# mean-shift steps and 3 NMS column-maxes a shape in phase A (the
# bandwidth's k of 1250 takes the dense path, not K1), one backward
E2E_PER_STEP = {"K1": 6, "K2": 5 * E2E_SHAPES, "K2b": 0, "K2 bf16": 0,
                "K2b bf16": 0, "K3": 3 * E2E_SHAPES, "K4": 0, "K5": 0,
                "K6": 6, "K6b": 3}


def e2e_card_vs_cpu(model, cfg, params0, args):
    """Step 1's loss and gradients recomputed from its starting parameters
    and its inputs (the batch, phase B's arrays, the bandwidths, the
    triplet draws) on the card, and on the CPU in float32 and in float64,
    the CPU on the card's kNN graphs (`_Graphs`), so that the card differs
    from the CPU by its arithmetic alone. The loss is held to the CPU's
    float32 loss within E2E_LOSS_RTOL. Each gradient leaf (the edge head
    feeds no term of this loss and has none) is held to the float64 step
    within E2E_GRAD_RTOL, or within twice the CPU float32 step's own
    distance from it where that is larger: some leaves are ill-conditioned
    in float32 (`f64_errors`' rule)."""
    import copy

    import torch
    from sednet_tpu_torch.parsenet_e2e import make_e2e_loss_fn

    def run(dev, replay=None, dtype=torch.float32):
        m = copy.deepcopy(model).to(dev)
        m.load_state_dict(params0)
        m.to(dtype)
        m.zero_grad(set_to_none=True)
        batch = {k: v.to(dev, dtype if v.is_floating_point() else v.dtype)
                 for k, v in args[0].items()}
        arrays, bws = tuple(a.to(dev) for a in args[1]), args[2].to(dev)
        draws = [d.to(dev) for d in args[3]]
        t0 = time.time()
        with _Graphs(replay) as graphs:
            total, metrics = make_e2e_loss_fn(m, cfg)(batch, arrays, bws,
                                                      draws)
            total.backward()
        grads = {k: p.grad.detach().cpu().double()
                 for k, p in m.named_parameters() if p.grad is not None}
        return (float(total.detach()), grads,
                [g.cpu() for g in graphs.graphs],
                {k: float(v) for k, v in metrics.items()}, time.time() - t0)

    card = run(DEVICE)
    cpu = run("cpu", replay=card[2])
    exact = run("cpu", replay=card[2], dtype=torch.float64)
    if not card[1].keys() == cpu[1].keys() == exact[1].keys():
        raise AssertionError("parsenet_e2e: gradient leaves differ")

    def rel(a, b):
        return {k: float((a[1][k] - b[1][k]).norm()
                         / b[1][k].norm().clamp_min(1e-30)) for k in b[1]}

    vs_cpu, card_f64, cpu_f64 = rel(card, cpu), rel(card, exact), rel(cpu,
                                                                     exact)
    allowed = {k: max(E2E_GRAD_RTOL, 2.0 * cpu_f64[k]) for k in card_f64}
    over = {k: (card_f64[k], allowed[k]) for k in card_f64
            if card_f64[k] > allowed[k]}
    worst = sorted(card_f64, key=lambda k: card_f64[k] / allowed[k])[-4:]
    rec = {"loss": card[0], "cpu_loss": cpu[0], "f64_loss": exact[0],
           "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
           "metrics": card[3], "cpu_metrics": cpu[3],
           "grad_leaves": len(vs_cpu),
           "grad_rel_err_vs_cpu_max": max(vs_cpu.values()),
           "grad_rel_err_vs_cpu_median": sorted(vs_cpu.values())[
               len(vs_cpu) // 2],
           "leaves_over_1e-3_vs_cpu": sorted(
               k for k, v in vs_cpu.items() if v > E2E_GRAD_RTOL),
           "worst_vs_f64": {k: {"card": card_f64[k], "cpu_f32": cpu_f64[k],
                                "vs_cpu": vs_cpu[k]} for k in worst},
           "cpu_f32_vs_f64_max": max(cpu_f64.values()),
           "over_allowed": over, "cpu_step_s": cpu[4],
           "cpu_f64_step_s": exact[4]}
    rec["ok"] = rec["loss_rel_err"] <= E2E_LOSS_RTOL and not over
    return rec


def phase_parsenet_e2e(models, card):
    """ParseNet's end-to-end trainer (`parsenet_e2e.e2e_train_batch`) under
    the production config (`train_cfg`: 4 x 10000 points, k 64, embed 128,
    AdamW at lr 1e-4 through `train.init_training`), the inst model of
    checkpoints/bench_10k.npz preloaded, fitting_weight 1.0, for E2E_STEPS
    steps on E2E_SHAPES synthetic clouds of 10000 points
    (`headline_shapes` from E2E_SEED: normalised, PCA-aligned, 6 segments;
    the repository has no ParseNet h5). Held to: every step's losses
    finite, the fit term above 0 with at least one matched geometric
    segment per shape in step 1, each step's launches (E2E_PER_STEP: K2,
    K3, K6 and K6b among them), step 1 on the card against the CPU
    (`e2e_card_vs_cpu`). Reported: step ms (median of the steps after the
    first), phase A / B / C ms of each step, peak GiB."""
    import copy
    import shutil

    import numpy as np
    import torch
    from sednet_tpu_torch import parsenet_e2e as E
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.predict import headline_shapes
    from sednet_tpu_torch.weights import save_params_npz

    root = os.path.join(ROOT, "build", "e2e_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    preload = os.path.join(root, "preload_inst.npz")
    save_params_npz(preload, models["inst"])
    cfg = train_cfg(preload)
    model, optimizer, gen = T.init_training(cfg, DEVICE)
    shapes, _ = headline_shapes(E2E_SHAPES, N_POINTS, seed=E2E_SEED)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in shapes])).to(DEVICE)
             for k in ("points", "normals", "labels", "prim")}
    step = E.make_e2e_train_step(model, optimizer, cfg, fitting_weight=1.0)
    seen = []

    def recording(*args):
        seen.append(args)
        return step(*args)

    state = T.TrainState(model, optimizer, 0)
    params0 = copy.deepcopy(model.state_dict())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(E2E_STEPS):
        timings = {}
        reset_counts()
        t0 = time.time()
        state, metrics = E.e2e_train_batch(model, state, batch, cfg,
                                           recording, gen, timings=timings)
        torch.cuda.synchronize()
        wall = time.time() - t0
        a, b = (timings[E.STAGES[0]], timings[E.STAGES[1]])
        steps.append({"ms": wall * 1e3, "phase_a_ms": a * 1e3,
                      "phase_b_ms": b * 1e3,
                      "phase_c_ms": (wall - a - b) * 1e3,
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "launches": read_counts()})
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seg_types = seen[0][1][1].cpu().numpy()
    matched = (seg_types > 0).sum(1).tolist()
    finite = all(math.isfinite(v) for s in steps
                 for v in s["metrics"].values())
    fit_ok = all(s["metrics"]["fit"] > 0 for s in steps) and min(matched) >= 1
    launches_ok = all(s["launches"] == E2E_PER_STEP for s in steps)
    versus_cpu = e2e_card_vs_cpu(model, cfg, params0, seen[0])
    # the recomputation from step 1's parameters and inputs gives step 1's
    # loss, a forward's value that no backward (K6b among them) enters;
    # held to 1e-5 of it, and whether the bits agree is recorded
    same_step = abs(versus_cpu["loss"] - steps[0]["metrics"]["loss"]) <= (
        1e-5 * abs(steps[0]["metrics"]["loss"]))
    rec = {"phase": "parsenet_e2e",
           "ok": (finite and fit_ok and launches_ok and same_step
                  and versus_cpu["ok"]), "card": card,
           "config": "configs/config_SEDNet_normal.yml",
           "batch": [E2E_SHAPES, N_POINTS], "k": cfg.knn,
           "fitting_weight": 1.0, "steps": steps,
           "step_ms_median_after_first": float(np.median(
               [s["ms"] for s in steps[1:]])),
           "matched_geometric_segments": matched, "peak_gib": peak_gib,
           "launches_per_step_expected": E2E_PER_STEP,
           "card_vs_cpu": versus_cpu,
           "step1_loss_recomputed_same_bits": (
               versus_cpu["loss"] == steps[0]["metrics"]["loss"]),
           "cut": "4 synthetic clouds and 3 steps: the repository has no "
                  "ParseNet h5"}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"parsenet_e2e: finite {finite}, fit {fit_ok}, "
                             f"launches {launches_ok}, step 1 recomputed "
                             f"{same_step}, card against CPU {versus_cpu}")
    del model, optimizer, state, seen
    torch.cuda.empty_cache()
    return {k: sum(s["launches"][k] for s in steps) for k in E2E_PER_STEP}


PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
IOU_CPU_SHAPES = 1        # miou_loss_edge's CPU side: its plain top-k sorts
RESPLIT_TIE = 1e-5        # K3's pick this close to the best: a near-tie
RESPLIT_MERGED_QUANTILE = 0.1   # the pass whose instances really split
# exps a second on the SFUs: 16 a cycle an SM, 132 SMs, the 1.98 GHz boost
EXP_RATE = 132 * 16 * 1.98e9


def bf16_bound(b, n, e, e_run):
    """The bound of K2/K2b's bf16 branch, the largest of: the two products'
    4 b n^2 e flops over the dense bf16 peak, the b n^2 exps over the SFUs'
    rate (both operations), and the float32 inputs and output once over
    the memory rate; `bound_run_width_ms` is the products at the padded
    width the kernel runs."""
    t = {"products": 4 * b * n * n * e / PEAK_BF16_FLOPS,
         "exps": b * n * n / EXP_RATE,
         "bytes": 4 * 3 * b * n * e / PEAK_BYTES}
    by = max(t, key=t.get)
    return {"bound_ms": 1e3 * t[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_parts_ms": {k: 1e3 * v for k, v in t.items()},
            "bound_run_width_ms": 4e3 * b * n * n * e_run / PEAK_BF16_FLOPS}


def check_k2_bf16(case, x_e, bw, parent=None):
    """K2's (one shape, x_e (1, N, E)) or K2b's (a batch) bf16 kernel on
    x_e padded once to the kernel width and its columns cast to bf16 once,
    as the loops do, against the plain bf16 version at E by `f64_errors`'
    rule: against the same function in float64 on the bf16-rounded inputs,
    every element at most twice the plain version's largest error (these
    fixed inputs need no weight held apart); then by the shared rule of
    `ops.bf16_rule.check_bf16_step`, which holds apart the weights within
    float32's error of a bf16 rounding midpoint, its counts under `rule`
    (`held_apart`, and `held_flipped`, the ones a row needed rounded to
    their other neighbour: 0 while the first rule passes); and the same
    bits on three launches. Timed: the call, 20 calls' device time (`device_ms`, the
    query's cast included), the launch alone (`kernel_ms`) and, given
    `parent` (`parent_ms_bf16`), the parent tree's launch on the same bf16
    inputs at its own kernel width (`parent_kernel_ms`); the plain version, attention in bf16 (the
    same normalised kernel-weighted mean) as the yardstick, the bound and
    the achieved TFLOP/s of the products."""
    import torch
    import torch.nn.functional as F
    from sednet_tpu_torch.ops import _build
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.ops.bf16_rule import check_bf16_step

    b, n, e = x_e.shape
    xp = ck.kernel_width(x_e, bf16=True)
    cols = ck.step_columns(xp, True)
    inv_b2 = 1.0 / (bw * bw)
    if b == 1:
        def fn():
            return ck.mean_shift_step(xp[0], cols[0], bw[0], bf16=True)[None]
    else:
        def fn():
            return ck.mean_shift_step_batched(xp, cols, bw, bf16=True)

    out = fn()
    again = [fn() for _ in range(2)]
    got = out[..., :e]
    plain = ck.mean_shift_step_plain(x_e, x_e, inv_b2, bf16=True)
    exact = ck.mean_shift_step_plain(x_e.double(), x_e.double(),
                                     inv_b2.double(), bf16=True)
    torch.cuda.synchronize()
    if float(out[..., e:].abs().sum()) != 0.0:
        raise AssertionError(f"{case}: padding columns not zero")
    if not all(torch.equal(out, a) for a in again):
        raise AssertionError(f"{case}: three launches differ")
    del again
    xb = x_e.to(torch.bfloat16)
    qb = (x_e * inv_b2[:, None, None]).to(torch.bfloat16)

    def sdpa():
        return F.normalize(F.scaled_dot_product_attention(
            qb[:, None], xb[:, None], xb[:, None], scale=1.0)[:, 0].float(),
            dim=-1, eps=1e-12)

    qk = xp.to(torch.bfloat16)
    ib2 = inv_b2.to(torch.float32).contiguous()
    raw = torch.empty_like(xp)
    lib = _build.lib()

    def kernel():
        _build.check(lib.sednet_mean_shift_step_bf16(
            qk.data_ptr(), cols.data_ptr(), ib2.data_ptr(), b, n,
            xp.shape[-1], raw.data_ptr(), _build.stream_of(xp)), case)

    flops = 4.0 * b * n * n * e
    rec = {"case": case, "shape": [b, n, e], "run_width": xp.shape[-1],
           "max_abs_err": float((got - plain).abs().max()),
           "vs": "the plain bf16 version (held by the float64 rule)",
           **f64_errors(case, got, plain, exact),
           "rule": {k: v for k, v in check_bf16_step(
               case, got, plain, x_e, inv_b2).items() if k in (
               "bound", "held_apart", "held_flipped", "held_named",
               "rows_fitted", "rows_failed")},
           "same_bits_3_launches": True,
           "ms": time_ms(fn), "device_ms": burst_ms(fn),
           "kernel_ms": burst_ms(kernel),
           "plain_ms": time_ms(lambda: ck.mean_shift_step_plain(
               x_e, x_e, inv_b2, bf16=True), reps=3),
           "library_ms": time_ms(sdpa),
           "library_device_ms": burst_ms(sdpa),
           "library": "scaled_dot_product_attention on bf16 inputs",
           **bf16_bound(b, n, e, xp.shape[-1])}
    rec["tflops"] = flops / (rec["kernel_ms"] * 1e-3) / 1e12
    rec["tflops_run_width"] = rec["tflops"] * xp.shape[-1] / e
    if parent is not None:
        # the parent's kernel takes multiples of 32 (140 at 160)
        xq = _build.pad_width(x_e).to(torch.bfloat16)
        pout = torch.empty(xq.shape, device=xq.device)
        parent(xq, xq, ib2, pout)
        torch.cuda.synchronize()
        rec["parent_run_width"] = xq.shape[-1]
        rec["parent_kernel_ms"] = burst_ms(lambda: parent(xq, xq, ib2, pout))
        rec["parent_max_abs_diff"] = float(
            (pout[..., :e] - raw[..., :e]).abs().max())
        del pout, xq
    del out, got, plain, exact, raw, qk
    return rec


def _bf16_server(bundle, x_np):
    """The serve phase's bundle with ms_bf16 set in its config snapshot,
    served in this process (`BundleServer`, clustering on): one clustered
    request of one cloud, its launches, and its labels against the port's
    own clustering (`serve.cluster_shape` under the same config) with the
    server's generator."""
    import shutil

    import torch
    from sednet_tpu_torch import serve

    bdir = bundle + "_bf16"
    shutil.rmtree(bdir, ignore_errors=True)
    shutil.copytree(bundle, bdir)
    with open(os.path.join(bdir, "meta.json")) as f:
        meta = json.load(f)
    meta["config"]["ms_bf16"] = True
    with open(os.path.join(bdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    srv = serve.BundleServer(bdir, cluster=True, device=DEVICE)
    reset_counts()
    t0 = time.time()
    out = srv.predict([x_np[0]])[0]
    torch.cuda.synchronize()
    request_ms = 1e3 * (time.time() - t0)
    counts = read_counts()
    xt = torch.from_numpy(srv._pad([x_np[0]])[0]).to(DEVICE)
    with torch.no_grad():
        emb = srv.fns["inst_model"](xt)["embedding"][0]
    gen = serve.request_generators(torch.Generator().manual_seed(0), 1)[0]
    own = serve.cluster_shape(emb, xt[0, :, :3], xt[0, :, 3:6], srv.cfg, gen)
    rec = {"bundle": os.path.relpath(bdir, ROOT), "ms_bf16": srv.cfg.ms_bf16,
           "request_ms": request_ms, "launches": counts,
           "points": len(out["instances"]),
           "num_instances": out["num_instances"],
           "instances_equal_own": out["instances"] == own.labels.tolist()}
    rec["ok"] = (rec["instances_equal_own"] and counts["K2 bf16"] > 0
                 and counts["K2"] == 0 and rec["points"] == N_POINTS
                 and rec["num_instances"] >= 1)
    del srv
    return rec


def ms_bf16_inputs(models, x, emb):
    """The inputs of the `ms_bf16` phase's kernel cases: the headline
    embeddings' bandwidths (as `segment_batch` draws them), and the
    eval's 140-d enriched embeddings with theirs (as `cluster_batch` draws
    them). Returns (bw, emb_e, bw_e)."""
    import numpy as np
    import torch
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.predict import HEADLINE

    ns = HEADLINE.ms_num_samples
    bw = torch.stack([torch.clamp_min(compute_bandwidth(
        emb[i], ns, np.float32(HEADLINE.ms_quantile),
        generator=torch.Generator().manual_seed(i)), 0.003)
        for i in range(emb.shape[0])])
    emb_e, esels = eval_subsamples(models, x)
    bw_e = torch.stack([torch.clamp_min(compute_bandwidth(
        emb_e[i], ns, np.float32(HEADLINE.ms_quantile), sel=esels[i]), 0.003)
        for i in range(emb_e.shape[0])])
    return bw, emb_e, bw_e


# timed batches of each run of the ms_bf16 phase's eval, after its first
MS_BF16_REPS = 5


def phase_ms_bf16(models, shapes, x, emb):
    """`ms_bf16`: the reference-default eval (bench.py's config 2, 8 x
    10000) with ms_bf16 on and off on the same inputs (K2b bf16 then K3;
    the f32 run K2b), each timed over MS_BF16_REPS batches and held to the JAX package's bars across keys;
    K2 bf16 at (10000, 128) and K2b bf16 at (8, 10000, 128) and (8, 10000,
    140 at 144) against the plain bf16 version, each on three launches,
    and with --parent beside the parent tree's kernel (`check_k2_bf16`);
    the serve phase's bundle with ms_bf16 answering one clustered
    request."""
    import numpy as np
    import torch

    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    gen = torch.Generator().manual_seed(3)
    x0s = [torch.randn((N_POINTS, 12), generator=gen) for _ in range(BATCH)]
    sels = [torch.randperm(N_POINTS, generator=gen)[:5000]
            for _ in range(BATCH)]
    runs = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        rec, labels, _ = phase_predict(
            f"ms_bf16/{name}", models, batch, (x0s, sels), reps=MS_BF16_REPS,
            cfg=predict_cfg(ms_bf16=bf16), profiled=False)
        runs[name] = (rec, labels)
    f32, b16 = runs["f32"][0], runs["bf16"][0]
    ari = [_ari(a, b) for a, b in zip(runs["f32"][1], runs["bf16"][1])]

    bw, emb_e, bw_e = ms_bf16_inputs(models, x, emb)
    parent = (parent_ms_bf16(PARENT_TREE) if PARENT_TREE
              and parent_parts(PARENT_TREE)["ms_bf16"] else None)
    k2 = [check_k2_bf16("K2 bf16, one shape E=128", emb[:1], bw[:1],
                        parent)]
    k2b = [check_k2_bf16("K2b bf16 E=128", emb, bw, parent),
           check_k2_bf16("K2b bf16, enriched E=140", emb_e, bw_e, parent)]
    del emb_e
    server = _bf16_server(os.path.join(ROOT, "build", "serve_smoke",
                                       "bundle"), x.cpu().numpy())
    ok = (f32["ok"] and b16["ok"] and server["ok"]
          and b16["launches"]["K2b"] == 0 and b16["launches"]["K2"] == 0)
    keep = ("ok", "shapes_per_s", "batch_s_median", "batch_s_min",
            "batch_s_max", "timing", "inst_iou", "type_iou",
            "inst_recall", "launches", "per_shape", "peak_mem_gib")
    emit({"phase": "ms_bf16", "ok": ok,
          "bf16": {k: b16[k] for k in keep}, "f32": {k: f32[k] for k in keep},
          "ref": b16["ref"], "tol": b16["tol"],
          "ari_bf16_vs_f32": ari,
          "K2 bf16": k2, "K2b bf16": k2b, "server": server})
    if not ok:
        raise AssertionError(f"ms_bf16: f32 {f32['ok']}, bf16 {b16['ok']} "
                             f"{b16['launches']}, server {server}")
    return {"K2 bf16": k2, "K2b bf16": k2b}, server["launches"], b16[
        "launches"]


def phase_pointnet2_iou(models, x, labels):
    """`pointnet2_iou` on the eval batch (8 x 10000): `three_nn` through K1
    at k = 3 against the plain top-k (no set differs outside a near-tie);
    `miou_loss_edge` on the card against the CPU on the same inputs (the
    headline's instance maps one-hot, the inst model's edge logits; the
    CPU on the first IOU_CPU_SHAPES clouds, whose plain top-k sorts every
    row on the host); FPS to 1024 samples and `ball_query` (radius 0.05,
    32 samples) equal to the CPU's; `three_interpolate` of the embedding
    from the samples back to every point, forward and gradient within
    1e-5 relative of the CPU's on the same indices and weights."""
    import torch
    from sednet_tpu_torch.losses.iou_loss import miou_loss_edge
    from sednet_tpu_torch.ops import pointnet2 as P
    from sednet_tpu_torch.ops.flash_topk import compare_with_plain
    from sednet_tpu_torch.predict import forward

    xyz = x[..., :3].contiguous()
    k1 = check_topk(f"three_nn k=3 ({BATCH} shapes)", xyz, xyz, 3)
    emb, _, edge = forward(models["inst"], x)
    scores = torch.nn.functional.one_hot(labels.long(), 50).float().permute(
        0, 2, 1).contiguous()
    reset_counts()
    t0 = time.time()
    dist, idx = P.three_nn(xyz, xyz)
    loss = miou_loss_edge(xyz, scores, edge)
    fps = P.furthest_point_sampling(xyz, 1024)
    centers = P.gather_operation(xyz, fps)
    ball, count = P.ball_query(centers, xyz, radius=0.05, n_sample=32)
    d3, i3 = P.three_nn(xyz, centers.contiguous())
    w3 = P.interpolation_weights(d3)
    feats = P.gather_operation(emb, fps).detach().requires_grad_()
    w3 = w3.detach().requires_grad_()
    interp = P.three_interpolate(feats, i3, w3)
    cot = torch.randn(interp.shape, generator=torch.Generator().manual_seed(
        5)).to(DEVICE)
    (interp * cot).sum().backward()
    torch.cuda.synchronize()
    card_s = time.time() - t0
    counts = read_counts()
    cmp = compare_with_plain(xyz, xyz, 3, idx, dist * dist)

    c = IOU_CPU_SHAPES
    cpu_nn = P.three_nn(xyz[:c].cpu(), xyz[:c].cpu())[1]
    cpu_loss = float(miou_loss_edge(xyz[:c].cpu(), scores[:c].cpu(),
                                    edge[:c].cpu()))
    card_loss_c = float(miou_loss_edge(xyz[:c], scores[:c], edge[:c]))
    # a row whose nearest other point differs changes its shape's
    # intersection and union by at most one each, so its IoU by at most
    # 2 / (union - 1); with none, the losses agree to rounding
    second = (idx[:c, :, 1].cpu() != cpu_nn[..., 1]).sum(1).double()
    inst = scores[:c].argmax(1)
    bound = (torch.gather(inst, 1, idx[:c, :, 1]) != inst).double()
    epred = (edge[:c].argmax(-1) == 1).double()
    union = (bound.sum(1) + epred.sum(1) - (bound * epred).sum(1)).cpu()
    loss_tol = 1e-6 + float((2.0 * second / (union - 1.0).clamp_min(1.0))
                            .sum()) / c
    loss_ok = abs(card_loss_c - cpu_loss) <= loss_tol

    t0 = time.time()
    fps_cpu = P.furthest_point_sampling(xyz.cpu(), 1024)
    ball_cpu, count_cpu = P.ball_query(centers.cpu(), xyz.cpu(), radius=0.05,
                                       n_sample=32)
    feats_c = feats.detach().cpu().requires_grad_()
    w3_c = w3.detach().cpu().requires_grad_()
    interp_c = P.three_interpolate(feats_c, i3.cpu(), w3_c)
    (interp_c * cot.cpu()).sum().backward()
    cpu_s = time.time() - t0

    def rel(a, b):
        return float((a.cpu().double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-30))

    rec = {"phase": "pointnet2_iou", "K1 k=3": k1,
           "three_nn": {k: cmp[k] for k in (
               "bad_rows", "tie_rows", "swapped_rows", "rows", "max_abs_err",
               "nbr_err", "tol")},
           "launches": counts, "card_s": card_s, "cpu_s": cpu_s,
           "miou_loss_edge": {"loss": float(loss), "card_first": card_loss_c,
                              "cpu_first": cpu_loss, "cpu_shapes": c,
                              "nearest_differs": second.tolist(),
                              "tol": loss_tol},
           "fps_equal": bool(torch.equal(fps.cpu(), fps_cpu)),
           "ball_query_equal": bool(torch.equal(ball.cpu(), ball_cpu)
                                    and torch.equal(count.cpu(), count_cpu)),
           "ball_count_mean": float(count.float().mean()),
           "three_interpolate_rel": {
               "forward": rel(interp.detach(), interp_c.detach()),
               "grad_features": rel(feats.grad, feats_c.grad),
               "grad_weights": rel(w3.grad, w3_c.grad), "tol": 1e-5}}
    rec["ok"] = (cmp["bad_rows"] == 0 and loss_ok and rec["fps_equal"]
                 and rec["ball_query_equal"] and counts["K1"] == 3
                 and all(v <= 1e-5 for k, v in
                         rec["three_interpolate_rel"].items() if k != "tol"))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"pointnet2_iou: {rec}")
    return counts, k1


def _moved_rows(a, b):
    """The rows of labeling a whose cluster lies elsewhere in labeling b:
    the clusters of the two matched one to one where they share the most
    rows (Hungarian on their overlaps), and the rows outside the matched
    pairs. None where the two split alike, whatever ids they allot."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    table = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(table, (ia, ib), 1)
    r, c = linear_sum_assignment(-table)
    match = np.full(len(ua), -1)
    match[r] = c
    return np.nonzero(match[ia] != ib)[0]


class _HeldMeanShift:
    """Inside `with`, every K2 step and K3 column-max that
    `cluster.mean_shift` runs (its `mean_shift_step` and `colmax`) is held,
    at the inputs the path gave it, to its plain version on the same
    inputs on the card. A K2 step within 1e-5 of the float32 plain
    version, and the steps together by `f64_errors`' rule (`check`): the
    largest float64 error of the card's steps at most twice the largest of
    the plain version's on the same inputs. Step by step that ratio is
    noise: at E = 12 both err by about an ulp of the output (one step on an
    H100 read 8.3e-8 against 3.9e-8), so it is recorded
    (`k2_worst_step_ratio`, `k2_steps_over_2x`), not held. A K3 call by
    its picks: where K3's pick differs from the plain version's, the plain
    version's score of K3's pick must lie within RESPLIT_TIE of its own
    best (a near-tie; a pick outside the threshold counts as one if its
    chord lies within RESPLIT_TIE of it), and the best scores within
    RESPLIT_TIE of each other where they differ outside such ties. Raises
    at the first call that fails. The three K3 calls of an NMS
    (membership, the centres' vote, the final assignment) are counted
    apart in `ties`."""

    PASSES = ("membership", "vote", "assignment")

    def __init__(self):
        self.steps, self.k2_err, self.k2_f64 = 0, 0.0, []
        self.colmax_calls = 0
        self.ties = dict.fromkeys(self.PASSES, 0)

    def __enter__(self):
        import torch
        from sednet_tpu_torch.ops import cuda_kernels as ck

        # the module, which the package shadows with its function
        self.module = importlib.import_module(
            "sednet_tpu_torch.cluster.mean_shift")
        self.saved = (self.module.mean_shift_step, self.module.colmax)
        step, colmax = self.saved

        def held_step(new_x, x, bw, bf16=False):
            got = step(new_x, x, bw, bf16=bf16)
            inv_b2 = ck._inv_b2(bw, x).reshape(1)
            plain = ck.mean_shift_step_plain(new_x[None], x[None], inv_b2)[0]
            exact = ck.mean_shift_step_plain(new_x.double()[None],
                                             x.double()[None],
                                             inv_b2.double())[0]
            err = float((got - plain).abs().max())
            if err > 1e-5:
                raise AssertionError(f"resplit: K2 step {self.steps}: max abs "
                                     f"error {err} > 1e-5")
            self.k2_f64.append(tuple(float((t.double() - exact).abs().max())
                                     for t in (got, plain)))
            self.steps += 1
            self.k2_err = max(self.k2_err, err)
            return got

        def held_colmax(rows, cols, bias, thresh, gain):
            best, idx = colmax(rows, cols, bias, thresh, gain)
            pb, pi = ck.colmax_plain(rows, cols, bias, thresh, gain)

            def pick(i):   # the plain arithmetic's chord and score of a pick
                sim = (rows * cols[i.long()]).sum(1)
                return 2.0 - 2.0 * sim, gain * sim + bias[i.long()]

            chord, mine = pick(idx)
            edge = (chord - thresh).abs() <= RESPLIT_TIE
            edge_plain = (pick(pi)[0] - thresh).abs() <= RESPLIT_TIE
            # K3's pick scores within RESPLIT_TIE of the best, inside the
            # threshold or at its edge; or one side found no column where
            # the other's pick lies at the threshold's edge
            tie = (((chord < thresh) | edge) & (mine >= pb - RESPLIT_TIE)) | (
                (~torch.isfinite(pb) & edge)
                | (~torch.isfinite(best) & edge_plain))
            moved = idx != pi
            close = (best == pb) | torch.isclose(best, pb, rtol=0.0,
                                                 atol=RESPLIT_TIE)
            bad = int(((moved | ~close) & ~tie).sum())
            name = self.PASSES[self.colmax_calls % 3]
            if bad:
                raise AssertionError(
                    f"resplit: K3 ({name} pass) picked {bad} rows that are "
                    f"no near-tie of its plain version")
            self.ties[name] += int((moved | ~close).sum())
            self.colmax_calls += 1
            return best, idx

        self.module.mean_shift_step = held_step
        self.module.colmax = held_colmax
        return self

    def __exit__(self, *exc):
        self.module.mean_shift_step, self.module.colmax = self.saved

    def check(self):
        """`f64_errors`' rule over the steps held so far; the record."""
        mine = max((k for k, _ in self.k2_f64), default=0.0)
        plain = max((p for _, p in self.k2_f64), default=0.0)
        if mine > 2.0 * plain:
            raise AssertionError(f"resplit: K2's steps: float64 error {mine} "
                                 f"above twice the plain version's {plain}")
        ratios = [k / max(p, 1e-30) for k, p in self.k2_f64]
        return {"k2_steps": self.steps, "k2_max_abs_err": self.k2_err,
                "k2_f64_err": mine, "k2_plain_f64_err": plain,
                "k2_worst_step_ratio": max(ratios, default=0.0),
                "k2_steps_over_2x": sum(r > 2.0 for r in ratios),
                "k3_calls": self.colmax_calls, "k3_near_tie_rows": self.ties}


class _Float64Steps:
    """Inside `with`, `cluster.mean_shift`'s steps are the plain version's
    in float64, rounded to float32 after each: a rounding of the same
    algorithm, to show how far the clustering moves for rounding alone."""

    def __enter__(self):
        from sednet_tpu_torch.ops import cuda_kernels as ck

        # the module, which the package shadows with its function
        self.module = importlib.import_module(
            "sednet_tpu_torch.cluster.mean_shift")
        self.saved = self.module.mean_shift_step

        def step(new_x, x, bw, bf16=False):
            inv_b2 = ck._inv_b2(bw, x).reshape(1).double()
            out = ck.mean_shift_step_plain(new_x.double()[None],
                                           x.double()[None], inv_b2)
            return out[0].float()

        self.module.mean_shift_step = step
        return self

    def __exit__(self, *exc):
        self.module.mean_shift_step = self.saved


def _resplit_pass(pts, nrm, labels, types, gen, quantile, sensitivity=False):
    """resplit_instances at `quantile` on each shape's instance map on the
    card, timed; again on the card with every K2 step and K3 call held to
    its plain version (`_HeldMeanShift`); and on the CPU with the same
    subsample draws (one a split candidate). Recorded a shape: the
    partitions' rows in another cluster (`_moved_rows`) between the card
    and the CPU, and with `sensitivity` between each of them and the same
    run on the card on float64 steps (`_Float64Steps`). Returns (records,
    the holds' record, card s, CPU s, the launches of the timed runs)."""
    import numpy as np
    import torch
    from sednet_tpu_torch.postproc.inst_cluster import (resplit_instances,
                                                        subsample_size)

    shapes, card_s, cpu_s, counts = [], 0.0, 0.0, {}
    held = _HeldMeanShift()
    for i in range(labels.shape[0]):
        big = [int(p) for p in np.unique(labels[i])
               if (labels[i] == p).sum() >= 0.15 * labels.shape[1]]
        sels = {}
        for p in big:
            rows = int((labels[i] == p).sum())
            sels[p] = torch.randperm(rows, generator=gen)[
                :min(subsample_size(rows), rows)]

        def run(dev):
            return resplit_instances(pts[i], nrm[i], labels[i], types[i],
                                     quantile=quantile, device=dev, sels=sels)

        reset_counts()
        t0 = time.time()
        card = run(DEVICE)
        torch.cuda.synchronize()
        card_s += time.time() - t0
        for k, v in read_counts().items():
            counts[k] = counts.get(k, 0) + v
        with held:
            held_card = run(DEVICE)
        t0 = time.time()
        cpu = run("cpu")
        cpu_s += time.time() - t0
        rec = {"candidates": big,
               "instances_before": int(len(np.unique(labels[i]))),
               "instances_after": int(len(np.unique(card))),
               "repeat_equal": bool((held_card == card).all()),
               "ids_equal": bool((card == cpu).all()),
               "rows_moved": int(len(_moved_rows(card, cpu)))}
        if sensitivity:
            with _Float64Steps():
                f64 = run(DEVICE)
            rec.update(instances_after_cpu=int(len(np.unique(cpu))),
                       instances_after_f64_steps=int(len(np.unique(f64))),
                       rows_moved_card_vs_f64_steps=int(len(
                           _moved_rows(card, f64))),
                       rows_moved_cpu_vs_f64_steps=int(len(
                           _moved_rows(cpu, f64))))
        shapes.append(rec)
    return shapes, held.check(), card_s, cpu_s, counts


def phase_resplit(model, x):
    """`resplit`: `resplit_instances` on the headline's 8 predicted instance
    maps (`segment_batch`) with their points, normals and predicted types,
    on the card (the bandwidth, 25 K2 steps at E = 12 padded to the kernel
    width, K3's NMS), every K2 step and K3 call held to its plain version
    at the inputs the path gave it (`_HeldMeanShift`), in two passes:
    quantile 0.5, where the card's partitions must be the CPU's with the
    same subsample draws; and RESPLIT_MERGED_QUANTILE on the same maps with
    each cloud's two largest instances merged, where instances split. There
    the card and the CPU part ways on a few clouds, as the CPU does from
    itself on float64 steps: recorded beside each other, not held, since
    rounding alone moves a split (every K2 and K3 call is held). Timed: K2
    at E = 12 on the largest candidate, beside its plain version,
    attention as the yardstick and its bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.postproc.inst_cluster import instance_features
    from sednet_tpu_torch.predict import segment_batch

    labels, types = segment_batch(model, x,
                                  generator=torch.Generator().manual_seed(6))
    pts = x[..., :3].cpu().numpy()
    nrm = x[..., 3:6].cpu().numpy()
    labels, types = labels.cpu().numpy(), types.cpu().numpy()
    shapes, held, card_s, cpu_s, counts = _resplit_pass(
        pts, nrm, labels, types, torch.Generator().manual_seed(7), 0.5)
    merged = labels.copy()
    for i in range(BATCH):
        ids, sizes = np.unique(labels[i], return_counts=True)
        keep, drop = ids[np.argsort(-sizes, kind="stable")[:2]]
        merged[i][labels[i] == drop] = keep
    m_shapes, m_held, m_card_s, m_cpu_s, m_counts = _resplit_pass(
        pts, nrm, merged, types, torch.Generator().manual_seed(7),
        RESPLIT_MERGED_QUANTILE, sensitivity=True)

    split = [(i, p) for i in range(BATCH) for p in shapes[i]["candidates"]]
    if not split:
        raise AssertionError("resplit: no instance above the ratio")
    sizes = [int((labels[i] == p).sum()) for i, p in split]
    i, p = split[int(np.argmax(sizes))]
    f12 = torch.from_numpy(instance_features(
        pts[i], nrm[i], types[i], labels[i] == p)).to(DEVICE)
    f = ck.kernel_width(f12)
    n, e = f12.shape
    inv_b2 = torch.full((1,), 100.0, device=DEVICE)   # bandwidth 0.1
    k2 = {"case": f"resplit candidate ({n},{e}) at {f.shape[-1]}",
          "shape": [1, n, e], "run_width": f.shape[-1],
          "launches": counts["K2"] + m_counts["K2"],
          "max_abs_err": max(held["k2_max_abs_err"], m_held["k2_max_abs_err"]),
          "f64_err": max(held["k2_f64_err"], m_held["k2_f64_err"]),
          "plain_f64_err": max(held["k2_plain_f64_err"],
                               m_held["k2_plain_f64_err"]),
          "ms": time_ms(lambda: ck.mean_shift_step(f, f, 0.1)),
          "plain_ms": time_ms(lambda: ck.mean_shift_step_plain(
              f12[None], f12[None], inv_b2)),
          "library_ms": time_ms(lambda: F.normalize(
              F.scaled_dot_product_attention(
                  (f12 * 100.0)[None, None], f12[None, None],
                  f12[None, None], scale=1.0)[0, 0], dim=-1, eps=1e-12)),
          **split_bound(4 * n * n * e, n * n * (4 * e + 4), 4 * 3 * n * e)}
    ok = (all(s["rows_moved"] == 0 for s in shapes)
          and any(s["instances_after"] > s["instances_before"]
                  for s in m_shapes)
          and counts["K2"] > 0 and counts["K3"] > 0)
    emit({"phase": "resplit", "ok": ok, "shapes": shapes, "held": held,
          "candidate_points": sizes, "launches": counts, "card_s": card_s,
          "cpu_s": cpu_s, "merged": {
              "quantile": RESPLIT_MERGED_QUANTILE, "shapes": m_shapes,
              "held": m_held, "launches": m_counts, "card_s": m_card_s,
              "cpu_s": m_cpu_s},
          "k2_e12": k2, "near_tie": RESPLIT_TIE})
    if not ok:
        raise AssertionError(f"resplit: {shapes} merged {m_shapes} "
                             f"launches {counts}")
    return counts, k2


def phase_tools():
    """`tools`: `gen_vis` over the predict CLI's dumps (build/predict_cli/
    full): every shape's four coloured dumps; `data.native` built with g++
    on this host into build/, its `savetxt_fast` rewriting each of those
    arrays, byte for byte the files gen_vis wrote through np.savetxt, and
    the integer label dumps the same way."""
    import numpy as np
    from sednet_tpu_torch import gen_vis
    from sednet_tpu_torch.data import native

    src = os.path.join(ROOT, "build", "predict_cli", "full")
    t0 = time.time()
    dst = gen_vis.gen_total_vis(src, workers=8)
    vis_s = time.time() - t0
    t0 = time.time()
    native.build()
    build_s = time.time() - t0
    check = os.path.join(ROOT, "build", "tools_smoke")
    os.makedirs(check, exist_ok=True)
    differ, files = [], 0
    for sid in range(BATCH):
        arrays = gen_vis.gen_vis(src, sid)
        for kind, arr in arrays.items():
            path = os.path.join(check, f"{sid}_{kind}.txt")
            native.savetxt_fast(path, arr, fmt="%0.4f", delimiter=";")
            files += 1
            with open(path, "rb") as a, open(os.path.join(
                    dst, f"{sid}_{kind}.txt"), "rb") as b:
                if a.read() != b.read():
                    differ.append(f"{sid}_{kind}")
        ids = np.loadtxt(os.path.join(src, f"{sid}_inst.txt")).astype(int)
        for name, write in (("native", native.savetxt_fast),
                            ("numpy", np.savetxt)):
            write(os.path.join(check, f"{sid}_inst_{name}.txt"), ids,
                  fmt="%d")
        with open(os.path.join(check, f"{sid}_inst_native.txt"), "rb") as a, \
                open(os.path.join(check, f"{sid}_inst_numpy.txt"), "rb") as b:
            if a.read() != b.read():
                differ.append(f"{sid}_inst")
    ok = files == 4 * BATCH and not differ
    emit({"phase": "tools", "ok": ok, "gen_vis_s": vis_s,
          "vis_files": len(os.listdir(dst)), "native_build_s": build_s,
          "native_files_checked": files + BATCH, "bytes_differ": differ})
    if not ok:
        raise AssertionError(f"tools: {files} files, differ {differ}")


# --- slice 16: the direct edge convolution and bf16 compute, K1's row
# order, multi-device --------------------------------------------------------

BF16_MODEL_STEP_REPS = 3


def phase_bf16_model(models, shapes):
    """`bf16_model`: the reference-default eval (bench.py's config 2, 8 x
    10000, both models of bench_10k.npz) with the direct edge convolution
    (`factored_gn` off) in float32 and with bf16 compute (`model_bf16`),
    each held to the predict phase's JAX bars (the float32 eval's spread
    across keys: the JAX package has no bf16 reference); then one train
    step of each at 4 x 10000 under the production config, timed, and held
    for its first cloud to the CPU's float64 step on the card's graphs and
    the card's maxima of the direct branch (`card_vs_cpu_step`). Returns
    K1's launches of the evals."""
    import dataclasses

    import numpy as np
    import torch
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.data import BatchLoader
    from sednet_tpu_torch.predict import load_models
    from sednet_tpu_torch.weights import save_params_npz

    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    gen = torch.Generator().manual_seed(3)
    x0s = [torch.randn((N_POINTS, 12), generator=gen) for _ in range(BATCH)]
    sels = [torch.randperm(N_POINTS, generator=gen)[:5000]
            for _ in range(BATCH)]
    root = os.path.join(ROOT, "build", "bf16_model")
    os.makedirs(root, exist_ok=True)
    preload = os.path.join(root, "preload_inst.npz")
    save_params_npz(preload, models["inst"])
    mixed, _ = train_sets()
    k1 = 0
    for tag, flags in (("direct_f32", dict(factored_gn=False)),
                       ("bf16", dict(model_bf16=True))):
        cfg = predict_cfg(**flags)
        pair = load_models(os.path.join(ROOT, "checkpoints",
                                        "bench_10k.npz"), cfg, device=DEVICE)
        rec, _, _ = phase_predict(f"bf16_model {tag}", pair, batch,
                                  (x0s, sels), cfg=cfg, reps=1,
                                  profiled=False)
        k1 += rec["launches"]["K1"]
        del pair
        tcfg = dataclasses.replace(train_cfg(preload), **flags)
        model, optimizer, tgen = T.init_training(tcfg, DEVICE)
        tb = T.to_device(next(iter(BatchLoader(mixed, tcfg.batch_size,
                                               shuffle=False))), DEVICE)
        versus = card_vs_cpu_step(model, tcfg, tb)
        step = T.make_train_step(model, optimizer, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        metrics = step(tb, generator=tgen)
        torch.cuda.synchronize()
        step_counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(list(losses.values()))):
            raise AssertionError(f"bf16_model {tag}: step not finite {losses}")
        if step_counts["K1"] <= 0:
            raise AssertionError(f"bf16_model {tag}: the step launched K1 "
                                 "no time")
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError(f"bf16_model {tag}: parameters left float32")
        rec.update({"train_step": {
            "batch": [tcfg.batch_size, tcfg.num_points], "metrics": losses,
            "launches": step_counts,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "step_ms": time_ms(lambda: step(tb, generator=tgen),
                               reps=BF16_MODEL_STEP_REPS, warmup=1),
            "card_vs_cpu": versus}})
        rec["train_step"]["shapes_per_s"] = (
            tcfg.batch_size * 1e3 / rec["train_step"]["step_ms"])
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"bf16_model {tag}: metrics out of "
                                 f"tolerance {rec}")
        del model, optimizer, step, tb
        torch.cuda.empty_cache()
    return {"K1": k1}


def row_order_cases(model, models, x, emb):
    """The four cases of K1's row order: the eval's bandwidth kNN (one
    shape's 5000-row subsample of the enriched 140-d embedding, at 160),
    the headline's (5000, 128), the spectral farthest-50 on one cloud's
    xyz and the encoder's layer-2 graph (8, 10000, 64), as (name, q, k,
    largest, the points' xyz where the encoder's own xyz order applies)."""
    head = {c[0]: c for c in k1_headline_cases(model, x, emb)}
    emb_e, sels = eval_subsamples(models, x)
    ev = k1_eval_cases(x, emb_e, sels)
    one_bw = [c for c in ev if c[0].startswith("bandwidth")
              and c[0].endswith("one shape")][0]
    one_far = [c for c in ev if c[0].startswith("spectral")
               and c[0].endswith("one shape")][0]
    return [(one_bw[0], one_bw[1], one_bw[3], False, None),
            ("bandwidth (5000,128)", head["bandwidth"][1], 128, False, None),
            (one_far[0], one_far[1], one_far[3], True, None),
            ("knn layer 2", head["knn layer 2"][1], K, False,
             x[..., :3].contiguous())]


def check_row_order(name, q, k, largest, xyz, parent=None):
    """K1 on q against itself unsorted and with `spatial_sort` (the order
    of its rows, K1 keyed by their original indices, the rows put back):
    both held to the plain version (`compare_with_plain`, bad_rows 0), the
    sorted one's indices to the unsorted one's (ties to the lower original
    index on both). Timed: the whole sorted call, the unsorted call, the
    order alone (`locality_order` on the rows and the gather into sorted
    order) and K1 alone on the sorted rows; with xyz, K1 on the rows in
    the points' Morton order (the encoder's `sort_points`); with `parent`,
    the parent tree's K1 on the unsorted rows."""
    import torch
    from sednet_tpu_torch.ops.flash_topk import (compare_with_plain,
                                                 flash_topk, sort_keys)
    from sednet_tpu_torch.ops.graph import locality_order

    def unsorted():
        return flash_topk(q, q, k, largest=largest, spatial_sort=False,
                          return_distances=True)

    def whole():
        return flash_topk(q, q, k, largest=largest, spatial_sort=True,
                          return_distances=True)

    q3 = q[None] if q.dim() == 2 else q

    def order(keys=None):
        perm = locality_order(sort_keys(q3, "sqdist") if keys is None
                              else keys).long()
        return perm, torch.gather(q3, 1, perm[..., None].expand(
            -1, -1, q3.shape[-1])).contiguous()

    def k1_on(perm, qs):
        ids = perm.to(torch.int32).contiguous()
        return lambda: torch.ops.sednet.topk(qs, qs, k, "sqdist", 1.0,
                                             bool(largest), ids)

    (i0, d0), (i1, d1) = unsorted(), whole()
    torch.cuda.synchronize()
    reps = [compare_with_plain(q, q, k, i, d, largest=largest)
            for i, d in ((i0, d0), (i1, d1))]
    perm, qs = order()
    rec = {"case": name, "shape": list(q.shape), "k": k, "largest": largest,
           "bad_rows": reps[1]["bad_rows"],
           "bad_rows_unsorted": reps[0]["bad_rows"],
           "tie_rows": reps[1]["tie_rows"],
           "max_abs_err": reps[1]["max_abs_err"],
           "same_indices_as_unsorted": bool(torch.equal(i0, i1)),
           "unsorted_ms": time_ms(unsorted), "sorted_ms": time_ms(whole),
           "order_ms": time_ms(order), "k1_on_sorted_ms": time_ms(
               k1_on(perm, qs)),
           "unsorted_device_ms": burst_ms(unsorted),
           "k1_on_sorted_device_ms": burst_ms(k1_on(perm, qs))}
    if xyz is not None:
        pxyz, qx = order(xyz)
        run = k1_on(pxyz, qx)
        rec["xyz_order_ms"] = time_ms(lambda: order(xyz))
        rec["k1_on_xyz_sorted_ms"] = time_ms(run)
        rec["k1_on_xyz_sorted_device_ms"] = burst_ms(run)
        rec["xyz_sorted_same_indices"] = bool(torch.equal(
            _unsort_ids(run()[1], pxyz), i0))
    # K1's launch alone through ctypes, no column ids, as the parent's is
    # called: the device time of 20 launches each
    raw = _k1_raw()
    rec["k1_launch_device_ms"] = burst_ms(lambda: raw(q, q, k, largest))
    if parent is not None:
        rec["parent_ms"] = time_ms(lambda: parent(q, q, k, largest))
        rec["parent_launch_device_ms"] = burst_ms(
            lambda: parent(q, q, k, largest))
        rec["parent_same_indices"] = bool(torch.equal(
            parent(q, q, k, largest).long().reshape(i0.shape), i0))
    rec["sorting_pays"] = rec["sorted_ms"] < rec["unsorted_ms"]
    if rec["bad_rows"] or rec["bad_rows_unsorted"] \
            or not rec["same_indices_as_unsorted"]:
        raise AssertionError(f"row_order {name}: {rec}")
    return rec


def _k1_raw():
    """This tree's K1 launched through its C interface with no column-id
    table, as `parent_topk` calls the parent's: call(q, p, k, largest) ->
    int32 indices."""
    import torch
    from sednet_tpu_torch.ops import _build

    lib = _build.lib()

    def call(q, p, k, largest=False):
        q3 = q[None] if q.dim() == 2 else q
        b, m, d = q3.shape
        n = p.shape[-2]
        dist = torch.empty((b, m, k), device=q.device)
        idx = torch.empty((b, m, k), dtype=torch.int32, device=q.device)
        _build.check(lib.sednet_topk(
            q3.data_ptr(), p.data_ptr(), m * d, 0 if p.dim() == 2 else n * d,
            b, m, n, d, k, 0, 1.0, int(largest), 0, 0, dist.data_ptr(),
            idx.data_ptr(), _build.stream_of(q)), "K1")
        return idx

    return call


def _unsort_ids(idx_sorted, perm):
    """K1's ids (original indices) listed for rows in the order perm, put
    back in the rows' original order."""
    import torch

    inv = torch.argsort(perm, dim=1)
    return torch.gather(idx_sorted, 1, inv[..., None].expand(
        -1, -1, idx_sorted.shape[-1]))


def phase_row_order(model, models, x, emb):
    """`row_order`: K1 sorted and unsorted at the four cases of
    `row_order_cases`, each by `check_row_order` (bad_rows 0 both ways,
    the same indices), the order's own ms beside K1's, the parent tree's
    K1 in the same call under --parent. K1's launches of one sorted call a
    case counted. Returns them."""
    import torch

    parent = (parent_topk(PARENT_TREE)
              if PARENT_TREE and parent_parts(PARENT_TREE)["topk"] else None)
    from sednet_tpu_torch.ops.flash_topk import flash_topk

    cases = row_order_cases(model, models, x, emb)
    # the path: each case's sorted call once (the checks' timed calls after
    # it count nothing)
    torch.cuda.synchronize()
    reset_counts()
    for _, q, k, largest, _ in cases:
        flash_topk(q, q, k, largest=largest, spatial_sort=True)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["K1"] <= 0:
        raise AssertionError("row_order launched K1 no time")
    recs = [check_row_order(name, q, k, largest, xyz, parent)
            for name, q, k, largest, xyz in cases]
    emit({"phase": "row_order", "card": nvidia_smi(), "cases": recs,
          "launches": counts})
    return counts


def _deterministic():
    """Inside `with`, torch's deterministic algorithms (warnings only where
    an op has none): the triplet loss's repeated-index `index_put_` adds in
    a fixed order, so that two equal train steps give the same bits."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def scope():
        before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(before)

    return scope()


def phase_multi_device(models, shapes, x, emb, big_shapes, big_inputs,
                       big_labels):
    """`multi_device`: the port's multi-device paths on a one-rank NCCL
    group on the card (`parallel.init_mesh`, a FileStore under build/),
    whose collectives run on the one rank too (counted a path,
    `parallel.mesh.COLLECTIVES`; the ring of one rank exchanges nothing):
    data-parallel `predict_shapes_mesh` against the in-process
    `predict_shapes` on the 8 x 10000 eval with the same generator (every
    result equal); a data-parallel train step (4 x 10000, the production
    config) against the one-process step, bit for bit (both under torch's
    deterministic algorithms, `_deterministic`); `ring_knn` against K1 on
    one cloud's first graph and its layer-2 features (the same indices);
    `mean_shift_iterate_sharded` against `mean_shift_iterate` on one
    shape's embedding (the same bits); `big_cloud_segment(hpnet=True)` on
    one 32768-point cloud with predict_bigcloud's start block and
    subsample (`big_inputs`), its metrics held to that phase's JAX bars and
    its labels to that phase's by ARI within the same spread. Each path's
    launches counted and held."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.cluster.mean_shift import (compute_bandwidth,
                                                     mean_shift_iterate)
    from sednet_tpu_torch.data import BatchLoader
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.parallel import (big_cloud_segment, init_mesh,
                                           mean_shift_iterate_sharded,
                                           ring_knn)
    from sednet_tpu_torch.parallel.mesh import COLLECTIVES
    from sednet_tpu_torch.predict import predict_shapes, predict_shapes_mesh
    from sednet_tpu_torch.weights import save_params_npz

    root = os.path.join(ROOT, "build", "multi_device")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store = tempfile.mkdtemp(dir=root)
    mesh = init_mesh(0, 1, store, device=torch.device(DEVICE, 0))
    rec = {"phase": "multi_device", "card": nvidia_smi(),
           "backend": dist.get_backend(), "world_size": mesh.size}
    launches, collectives = {}, {}

    def counted(name, fn, need):
        torch.cuda.synchronize()
        reset_counts()
        before = dict(COLLECTIVES)
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_counts()
        collectives[name] = {k: v - before[k] for k, v in COLLECTIVES.items()
                             if v > before[k]}
        for key in need:
            if launches[name][key] <= 0:
                raise AssertionError(f"multi_device {name} launched {key} "
                                     "no time")
        # a sharded path issues its collectives on one rank too (a copy),
        # and the one-process step and the ring of one rank none
        if bool(collectives[name]) != (name not in ("train_step_one",)
                                       and not name.startswith("ring_knn")):
            raise AssertionError(f"multi_device {name}: collectives "
                                 f"{collectives[name]}")
        return out

    try:
        # data-parallel predict against the in-process eval
        batch = {k: np.stack([s_[k] for s_ in shapes])
                 for k in ("points", "normals", "labels", "prim")}
        cfg = predict_cfg()
        t0 = time.time()
        dp = counted("predict", lambda: predict_shapes_mesh(
            models["type"], models["inst"], batch, cfg, mesh,
            generator=torch.Generator().manual_seed(6)),
            ("K1", "K2b", "K3", "K6"))
        dp_s = time.time() - t0
        one = predict_shapes(models["type"], models["inst"], batch, cfg,
                             generator=torch.Generator().manual_seed(6))
        rec["predict"] = {"shapes": len(dp), "batch_s": dp_s,
                          "fields_differing": _same_results(dp, one),
                          "inst_iou": float(np.mean([r["inst_iou"]
                                                     for r in dp]))}

        # a data-parallel train step against the one-process step
        preload = os.path.join(root, "preload_inst.npz")
        save_params_npz(preload, models["inst"])
        tcfg = dataclasses.replace(train_cfg(preload), mesh_shape=1)
        mixed, _ = train_sets()
        tb = T.to_device(next(iter(BatchLoader(mixed, tcfg.batch_size,
                                               shuffle=False))), DEVICE)
        steps = []
        for m in (mesh, None):
            model, opt, _ = T.init_training(tcfg, DEVICE)
            step = T.make_train_step(model, opt, tcfg, m)
            with _deterministic():
                metrics = counted(f"train_step_{'dp' if m else 'one'}",
                                  lambda: step(tb, generator=torch.Generator(
                                      ).manual_seed(TRAIN_SEED)),
                                  ("K1", "K6", "K6b"))
            steps.append(({k: float(v) for k, v in metrics.items()},
                          {k: p.detach().clone()
                           for k, p in model.named_parameters()},
                          {k: p.grad.detach().clone()
                           for k, p in model.named_parameters()}))
            del model, opt, step
        differ = [k for k in steps[0][2]
                  if not torch.equal(steps[0][2][k], steps[1][2][k])
                  or not torch.equal(steps[0][1][k], steps[1][1][k])]
        rec["train_step"] = {"batch": [tcfg.batch_size, tcfg.num_points],
                             "metrics": steps[0][0],
                             "metrics_equal": steps[0][0] == steps[1][0],
                             "leaves_differing": differ}
        del steps, tb

        # ring kNN against K1 on one cloud
        x1 = _knn_inputs(models["inst"], x)[0]
        ring = {}
        for name, rows, metric in (("layer 1 (points_normals)", x[0],
                                    "points_normals"),
                                   ("layer 2", x1[0], "sqdist")):
            got = counted(f"ring_knn {name}", lambda: ring_knn(
                rows.contiguous(), K, mesh, metric=metric), ("K1",))
            want = flash_topk(rows.contiguous(), rows.contiguous(), K,
                              metric=metric, return_distances=True)
            ring[name] = {"same_indices": bool(torch.equal(got[0], want[0])),
                          "same_distances": bool(torch.equal(got[1],
                                                             want[1]))}
        rec["ring_knn"] = ring

        # the sharded shift against the one-process loop
        e0 = torch.nn.functional.normalize(emb[0], dim=-1).contiguous()
        bw = float(compute_bandwidth(e0, 5000, np.float32(0.015),
                                     generator=torch.Generator().manual_seed(
                                         0)))
        shifted = counted("mean_shift_sharded", lambda: (
            mean_shift_iterate_sharded(e0, bw, mesh, iterations=50)), ("K2",))
        rec["mean_shift_sharded"] = {"bandwidth": bw, "same_bits": bool(
            torch.equal(shifted, mean_shift_iterate(e0, bw, 50)))}

        # big_cloud_segment with the hpnet enrichment on one large cloud
        big = torch.from_numpy(np.concatenate(
            [big_shapes[0]["points"], big_shapes[0]["normals"]], -1)).to(
            DEVICE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        labels, num, types, _ = counted("big_cloud_segment", lambda: (
            big_cloud_segment(models["inst"], big, mesh, hpnet=True,
                              x0=big_inputs[0][0], sel=big_inputs[1][0])),
            ("K1", "K2", "K3", "K5"))
        seg_s = time.time() - t0
        got = _metrics(big_shapes[:1], [labels.cpu().numpy()],
                       [types.cpu().numpy()])
        rec["big_cloud_segment"] = {
            "points": int(big.shape[0]), "s": seg_s, "num_clusters": num,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            **got, "ref": REF_BIG_MEAN, "tol": BIG_TOL,
            "ari_vs_predict_bigcloud": _ari(labels.cpu().numpy(),
                                            big_labels[0]),
            "note": "type_iou from the inst model's type head"}
    finally:
        dist.destroy_process_group()
    rec["launches"] = launches
    rec["collectives"] = collectives
    inst_ok = abs(got["inst_iou"] - REF_BIG_MEAN["inst_iou"]) \
        <= BIG_TOL["inst_iou"]
    rec["ok"] = (not rec["predict"]["fields_differing"]
                 and rec["train_step"]["metrics_equal"]
                 and not rec["train_step"]["leaves_differing"]
                 and all(v["same_indices"] for v in ring.values())
                 and rec["mean_shift_sharded"]["same_bits"] and inst_ok
                 and rec["big_cloud_segment"]["ari_vs_predict_bigcloud"]
                 >= 1.0 - BIG_TOL["inst_iou"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"multi_device: {rec}")
    return launches


KERNELS = {
    "K1": ("flash_topk", "sednet_tpu_torch/csrc/flash_topk.cu",
           "sednet_tpu/ops/flash_topk.py:259"),
    "K2": ("mean_shift_step", "sednet_tpu_torch/csrc/mean_shift.cu",
           "sednet_tpu/ops/pallas_kernels.py:427"),
    "K2b": ("mean_shift_step_batched", "sednet_tpu_torch/csrc/mean_shift.cu",
            "sednet_tpu/ops/pallas_kernels.py:106"),
    # the bf16=True branch of the same two Pallas kernels (config.ms_bf16)
    "K2 bf16": ("mean_shift_step (bf16)",
                "sednet_tpu_torch/csrc/mean_shift_bf16.cu",
                "sednet_tpu/ops/pallas_kernels.py:427"),
    "K2b bf16": ("mean_shift_step_batched (bf16)",
                 "sednet_tpu_torch/csrc/mean_shift_bf16.cu",
                 "sednet_tpu/ops/pallas_kernels.py:106"),
    "K3": ("colmax", "sednet_tpu_torch/csrc/colmax.cu",
           "sednet_tpu/ops/pallas_kernels.py:184"),
    "K4": ("fused_edge_reductions", "sednet_tpu_torch/csrc/fused_edgeconv.cu",
           "sednet_tpu/ops/fused_edgeconv.py:204"),
    "K5": ("segsum_sorted_scan", "sednet_tpu_torch/csrc/segsum.cu",
           "sednet_tpu/ops/pallas_kernels.py:329"),
    "K6": ("gather_reduce", "sednet_tpu_torch/csrc/gather_reduce.cu",
           "scripts/probe_gather_pallas.py:82"),
    # no Pallas kernel: the gradient of XLA's gather that JAX differentiates
    "K6b": ("gather_reduce_backward",
            "sednet_tpu_torch/csrc/gather_reduce_bwd.cu",
            "sednet_tpu/ops/graph.py:118"),
}


def main():
    import argparse

    import torch

    global PARENT_TREE
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one NVIDIA GPU.")
    ap.add_argument("--parent", default=None,
                    help="an older checkout (e.g. unpacked with git archive "
                         "into build/parent) whose kernels the smoke times "
                         "on the same inputs: an atomic K6b in the train "
                         "phase, a bf16 mean-shift step in the ms_bf16 "
                         "phase, as far as its C interfaces match")
    PARENT_TREE = ap.parse_args().parent
    if PARENT_TREE:
        check_parent_tree(PARENT_TREE)
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
    models = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                         device=DEVICE)
    model = models["inst"]
    x = torch.from_numpy(x_np).to(DEVICE)
    emb = forward(model, x)[0].contiguous()

    timings = phase_kernels(model, x, emb)
    counts, head_labels = phase_headline(model, x, shapes)
    phase_cluster_batch(emb)
    for key, cases in phase_kernels_slice2(models, x).items():
        timings.setdefault(key, []).extend(cases)
    big_shapes, big_np = headline_shapes(BIG_BATCH, BIG_POINTS)
    big_x = torch.from_numpy(big_np).to(DEVICE)
    for key, cases in phase_kernels_slice3(models, x, big_x).items():
        timings.setdefault(key, []).extend(cases)
    pred = phase_predict_all(models, shapes)
    cli_counts = phase_predict_cli(models, shapes,
                                   pred["predict"]["launches"])
    fit_counts = phase_fit_pipeline(models, shapes, x)
    spline_counts, k1_spline = phase_fit_splines()
    timings["K1"].extend(k1_spline)
    phase_checkpoints(models, x)
    spline_train_k1, k1_spline_train = phase_splinenet_train()
    timings["K1"].extend(k1_spline_train)
    gen = torch.Generator().manual_seed(8)
    big_inputs = ([torch.randn((BIG_POINTS, 12), generator=gen)
                   for _ in range(BIG_BATCH)],
                  [torch.randperm(BIG_POINTS, generator=gen)[:5000]
                   for _ in range(BIG_BATCH)])
    matfree_counts, k2b_big = phase_spectral_matfree(models, big_shapes,
                                                     big_x, big_inputs)
    timings["K2b"].append(k2b_big)
    _, big_labels = phase_predict_bigcloud(models, big_shapes, big_inputs)
    train_counts, k6b = phase_train(models, card)
    timings["K6b"] = k6b
    serve_counts = phase_serve(models, x_np)
    e2e_counts = phase_parsenet_e2e(models, card)
    bf16_cases, serve_bf16_counts, predict_bf16_counts = phase_ms_bf16(
        models, shapes, x, emb)
    timings.update(bf16_cases)
    p2_counts, k1_three_nn = phase_pointnet2_iou(models, x, head_labels)
    timings["K1"].append(k1_three_nn)
    _, k2_resplit = phase_resplit(model, x)
    timings["K2"].append(k2_resplit)
    phase_tools()
    bf16_model_counts = phase_bf16_model(models, shapes)
    row_order_counts = phase_row_order(model, models, x, emb)
    md_counts = phase_multi_device(models, shapes, x, emb, big_shapes,
                                   big_inputs, big_labels)
    # each kernel's launches from the path of this smoke that runs it: K1,
    # K2b, K3 and K6 from the predict CLI's loop over the 8 clouds (K1 also
    # from the fit pipeline, the spline fits and the SplineNet trainer's
    # two loops), K2 from the headline, K4
    # from the eval's fused form, K5 from the "pallas" enrichment of the
    # large clouds
    counts.update({k: cli_counts[k] for k in ("K1", "K2b", "K3", "K6")})
    k1_by_path = {"predict_cli": cli_counts["K1"],
                  "fit_pipeline": fit_counts["K1"],
                  "fit_splines": spline_counts["K1"],
                  "splinenet_train": spline_train_k1,
                  "serve": serve_counts["K1"],
                  "parsenet_e2e": e2e_counts["K1"],
                  "pointnet2_iou": p2_counts["K1"],
                  "bf16_model": bf16_model_counts["K1"],
                  "row_order": row_order_counts["K1"],
                  "multi_device": sum(c["K1"] for c in md_counts.values())}
    counts["K1"] = sum(k1_by_path.values())
    counts["K4"] = pred["predict_fused"]["launches"]["K4"]
    counts["K5"] = matfree_counts["K5"]
    counts["K6b"] = train_counts["K6b"]
    # the bf16 branch: K2's from the ms_bf16 server's clustered request,
    # K2b's from the eval under ms_bf16
    counts["K2 bf16"] = serve_bf16_counts["K2 bf16"]
    counts["K2b bf16"] = predict_bf16_counts["K2b bf16"]

    summary = []
    for key, (name, source, replaces) in KERNELS.items():
        cases = timings[key]
        # K1, K4, K6 and K6b: the layer-2 case; K2b (and its bf16 branch):
        # the enriched E=140 case; K5: m = 36, the block of LOBPCG's
        # Rayleigh-Ritz matvec
        main_case = (cases[1] if key in ("K1", "K2b", "K2b bf16", "K4", "K5",
                                         "K6", "K6b")
                     else cases[0])
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[key],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "bound_f32_ms": main_case.get("bound_f32_ms"),
            "library_ms": main_case["library_ms"],
            "case": main_case["case"], "parity": "ok",
            "cases_held": [c["case"] for c in cases],
            **({"launches_by_path": k1_by_path} if key == "K1" else {}),
            **({"device_ms": main_case["device_ms"],
                "kernel_ms": main_case["kernel_ms"],
                "tflops": main_case["tflops"],
                "earlier_kernel_ms": main_case.get("parent_kernel_ms")}
               if key.endswith("bf16") else {}),
            **({"device_ms": main_case["device_ms"],
                "device_split": main_case["device_split"],
                "earlier_device_ms": main_case.get("parent", {}).get(
                    "device_ms")} if key == "K6b" else {})})
    emit({"phase": "done", "seconds": time.time() - T_START})
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
