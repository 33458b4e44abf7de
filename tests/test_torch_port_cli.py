"""The port's predict CLI (sednet_tpu_torch.predict: run_prediction, main,
the double-buffered stream, the txt dumps; config.py, data/, weights.py,
cluster_batch's async/finalize halves) against the JAX package on the CPU,
at small sizes. The h5 files are written here with h5py."""
import dataclasses
import functools
import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sednet_tpu.config as cfg_jax
import sednet_tpu.data as data_jax
import sednet_tpu.predict as predict_jax
import sednet_tpu_torch.config as cfg_port
import sednet_tpu_torch.data as data_port
import sednet_tpu_torch.predict as predict_port
from sednet_tpu.train import load_params, save_params_npz
from sednet_tpu_torch.weights import load_checkpoint, load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "bench_10k.npz")
N = 128
# the module (the package's `mean_shift` name is the function)
ms = importlib.import_module("sednet_tpu_torch.cluster.mean_shift")


def ari(a, b):
    """Adjusted Rand index of two labelings."""
    a = np.unique(np.asarray(a), return_inverse=True)[1]
    b = np.unique(np.asarray(b), return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(table, (a, b), 1)

    def pairs(v):
        return (v * (v - 1) / 2).sum()

    total = pairs(np.array([len(a)]))
    sa, sb = pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / total
    top = 0.5 * (sa + sb) - expected
    return 1.0 if top == 0 else (pairs(table) - expected) / top


def assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- config.py -------------------------------------------------------------

def test_config_fields_and_defaults_match_jax():
    got = [(f.name, f.type, f.default)
           for f in dataclasses.fields(cfg_port.Config)]
    want = [(f.name, f.type, f.default)
            for f in dataclasses.fields(cfg_jax.Config)]
    assert got == want


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                        "*"))) + ["saved.json"])
def test_load_config_matches_jax(name, tmp_path):
    if name == "saved.json":
        path = str(tmp_path / name)
        cfg_jax.Config(knn=16, lr=0.1, dataset="my", mesh_shape=2,
                       spectral_matfree=True).save(path)
    else:
        path = os.path.join(ROOT, "configs", name)
    got, want = cfg_port.load_config(path), cfg_jax.load_config(path)
    assert got.asdict() == want.asdict()


# --- data/: the h5 writers, datasets and BatchLoader -------------------------

def _h5_tree(root):
    import h5py

    out = {}
    for path in sorted(glob.glob(os.path.join(root, "*", "*.h5"))):
        with h5py.File(path, "r") as hf:
            for k in hf:
                out[(os.path.relpath(path, root), k)] = np.array(hf[k])
    return out


@pytest.mark.parametrize("writer", ["write_parsenet_h5", "write_edge_h5"])
def test_h5_writers_match_jax(writer, tmp_path):
    getattr(data_port, writer)(str(tmp_path / "port"), n_shapes=3,
                               n_points=64, seed=5)
    getattr(data_jax, writer)(str(tmp_path / "jax"), n_shapes=3, n_points=64,
                              seed=5)
    got, want = _h5_tree(str(tmp_path / "port")), _h5_tree(str(tmp_path / "jax"))
    assert got.keys() == want.keys() and len(want) >= 4
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    """A ParseNet-schema and an Edge-schema test set of 5 shapes of N
    points, and single-model checkpoints carried over from the JAX
    package's params: the type model without a prefix, the inst model
    under "params/"."""
    root = str(tmp_path_factory.mktemp("h5"))
    data_port.write_parsenet_h5(root, n_shapes=5, n_points=N, seed=0)
    data_port.write_edge_h5(root, n_shapes=5, n_points=N, seed=1)
    params = load_params(CKPT)
    save_params_npz(os.path.join(root, "type.npz"), params["type"])
    save_params_npz(os.path.join(root, "inst.npz"), {"params": params["inst"]})
    return root


DATASETS = [("ParseNetDataset", False, {}), ("ParseNetDataset", True, {}),
            ("EdgeDataset", False, {}), ("EdgeDataset", True, {}),
            ("EdgeDataset", True, {"ret_edges1w": True}),
            ("ParseNetDataset", True, {"noise": True, "noise_level": 1}),
            ("EdgeDataset", False, {"noise": True, "noise_level": -1,
                                    "num_points": 100})]


# Items of both packages' datasets, eval and train (augmentation, the point
# subsample, the edge cloud, both kinds of noise), with the JAX package's
# numpy route (use_native=False): the same draws from the same seed.
@pytest.mark.parametrize("kind,train,kw", DATASETS)
def test_dataset_items_match_jax(h5_root, kind, train, kw):
    got = getattr(data_port, kind)(h5_root, train=train, seed=3, **kw)
    want = getattr(data_jax, kind)(h5_root, train=train, seed=3,
                                   use_native=False, **kw)
    assert len(got) == len(want) == 5
    for i in range(5):
        assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("batch_size,shuffle,drop_last,starts", [
    (2, False, False, 1), (3, False, False, 0), (2, True, True, 0),
    (4, False, True, 2)])
def test_batch_loader_matches_jax(h5_root, batch_size, shuffle, drop_last,
                                  starts):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=4, starts=starts)
    got = data_port.BatchLoader(data_port.EdgeDataset(h5_root, train=False),
                                batch_size, **kw)
    want = data_jax.BatchLoader(
        data_jax.EdgeDataset(h5_root, train=False, use_native=False),
        batch_size, **kw)
    got_b, want_b = list(got), list(want)
    assert len(got) == len(want) == len(want_b) == len(got_b)
    for g, w in zip(got_b, want_b):
        assert_items_equal(g, w)


# --- save_shape_outputs ------------------------------------------------------

def _fake_result(rng, n=50):
    item = {"points": rng.randn(n, 3).astype(np.float32),
            "normals": rng.randn(n, 3).astype(np.float32),
            "labels": rng.randint(0, 6, n).astype(np.int32),
            "prim": rng.randint(0, 10, n).astype(np.int32)}
    edge = rng.rand(n, 2).astype(np.float32)
    result = {"cluster_ids": rng.randint(0, 70, n).astype(np.int64),
              "pred_primitives": rng.randint(0, 6, n).astype(np.int64),
              "edge_prob": edge / edge.sum(1, keepdims=True)}
    return item, result


# The eight files of a shape, byte for byte: against the JAX package's
# np.savetxt route, and against its native writer where that library loads.
@pytest.mark.parametrize("route", ["numpy", "native"])
@pytest.mark.parametrize("save_gt", [True, False])
def test_save_shape_outputs_writes_jax_files(route, save_gt, tmp_path,
                                             monkeypatch):
    from sednet_tpu.data import native

    if route == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.available():
        pytest.skip("native/libsednet_preprocess.so does not load here")
    item, result = _fake_result(np.random.RandomState(2))
    predict_port.save_shape_outputs(str(tmp_path / "port"), 7, item, result,
                                    save_gt=save_gt)
    predict_jax.save_shape_outputs(str(tmp_path / "jax"), 7, item, result,
                                   save_gt=save_gt)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == (8 if save_gt else 6)
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name


# --- weights.py --------------------------------------------------------------

def test_load_checkpoint_reads_single_model_npz(h5_root):
    for path, which in (("type.npz", "type"), ("inst.npz", "inst")):
        got = load_checkpoint(os.path.join(h5_root, path), device="cpu")
        want = load_npz(CKPT, which, device="cpu")
        for (k, a), (k2, b) in zip(got.state_dict().items(),
                                   want.state_dict().items()):
            assert k == k2
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# The reference's .pth / .pt files and orbax directories, once refused,
# now load: the inst model written in each format gives the .npz route's
# model bit for bit; a path that does not exist raises.
@pytest.mark.parametrize("path", ["w.pth", "w.pt", "ckpts/best_inst"])
def test_load_checkpoint_names_what_is_not_ported(path, tmp_path):
    import orbax.checkpoint as ocp
    from sednet_tpu.utils.torch_import import flax_params_to_torch_state_dict

    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / path), device="cpu")
    params = load_params(CKPT)["inst"]
    target = str(tmp_path / path)
    if path.startswith("ckpts"):
        ocp.PyTreeCheckpointer().save(target, {"params": params})
    else:
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                    flax_params_to_torch_state_dict(params).items()}, target)
    got = load_checkpoint(target, device="cpu")
    want = load_npz(CKPT, "inst", device="cpu")
    for (k, a), (k2, b) in zip(got.state_dict().items(),
                               want.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- run_prediction ----------------------------------------------------------

def _cli_config(h5_root, dataset, **kw):
    return dict(num_points=N, knn=16, hpnet_embed=False, num_test=0,
                dataset=dataset,
                pretrain_model_path=os.path.join(h5_root, "type.npz"),
                pretrain_model_type_path=os.path.join(h5_root, "inst.npz"),
                **kw)


# The CLI's test loop end to end on the CPU, from the h5 files and the two
# checkpoints, through both packages: the ParseNet set in two batches and a
# partial one, and the Edge set from shape 1 with a limit that cuts the
# second batch. Every cloud's subsample is all of it (ms_num_samples >= N),
# so the bandwidths differ only by summation order.
#
# At N = 128 the mean-shift of a shape can split on the float association
# of the forward alone: the JAX package gives ParseNet shape 4 inst_iou
# 0.627000 in batches of 1 or 2 and 0.617938 in one batch of 5 (its
# embedding moves by ~2e-6). So each shape is held to the JAX run in the
# same batches and to a JAX run in one batch: it must equal one of them
# (ARI 1.0, the same cluster count, metrics within 1e-5), and where the two
# agree, that result. Types equal; the summary's keys and n_shapes equal,
# its means those of the matched runs; every dump file equal (inst labels
# as partitions, edge probabilities within one unit of their 4th decimal).
@pytest.mark.parametrize("dataset,starts,limit", [("", 0, None),
                                                  ("my", 1, 3)])
def test_run_prediction_matches_jax(h5_root, tmp_path, dataset, starts,
                                    limit):
    kw = dict(data_root=h5_root, starts=starts, limit=limit)
    got_sum, got = predict_port.run_prediction(
        cfg_port.Config(**_cli_config(h5_root, dataset)), batch_size=2,
        out_dir=str(tmp_path / "port"), device="cpu", **kw)
    runs = []
    for bs in (2, 5):
        out = str(tmp_path / f"jax{bs}")
        runs.append((out, *predict_jax.run_prediction(
            cfg_jax.Config(**_cli_config(h5_root, dataset)), batch_size=bs,
            out_dir=out, **kw)))
    assert got_sum.keys() == runs[0][1].keys() == runs[1][1].keys()
    n = limit or 5 - starts
    assert got_sum["n_shapes"] == runs[0][1]["n_shapes"] == n == len(got)
    matched = []
    for i, g in enumerate(got):
        hits = [r for r in runs
                if ari(g["cluster_ids"], r[2][i]["cluster_ids"]) == 1.0
                and g["num_clusters"] == r[2][i]["num_clusters"]
                and all(g[k] == pytest.approx(r[2][i][k], abs=1e-5)
                        for k in ("inst_iou", "type_iou", "inst_recall"))]
        assert hits, i
        agree = ari(runs[0][2][i]["cluster_ids"],
                    runs[1][2][i]["cluster_ids"]) == 1.0
        assert not agree or len(hits) == 2, i
        for r in runs:
            np.testing.assert_array_equal(
                g["pred_primitives"], np.asarray(r[2][i]["pred_primitives"]))
        matched.append((hits[0][0], hits[0][2][i]))
    for k in ("inst_iou", "type_iou", "inst_recall"):
        assert got_sum[k] == pytest.approx(
            np.mean([m[1][k] for m in matched]), abs=1e-5)
    for k in ("guard_capped", "guard_bw_capped"):
        assert got_sum[k] == runs[0][1][k] == 0

    def load(path):
        with open(path) as f:
            delim = ";" if ";" in f.readline() else None
        return np.loadtxt(path, delimiter=delim)

    names = sorted(n for n in os.listdir(runs[0][0]) if n.endswith(".txt"))
    assert sorted(n for n in os.listdir(tmp_path / "port")
                  if n.endswith(".txt")) == names
    assert len(names) == 8 * n
    for name in names:
        sid = int(name.split("_")[0])
        a = load(tmp_path / "port" / name)
        b = load(os.path.join(matched[sid - starts][0], name))
        if name.endswith(("_inst.txt", "_Vis_inst.txt")) and "GT" not in name:
            # the partition as labels, and the points of the colour dump
            assert ari(a if a.ndim == 1 else a[:, 3:].sum(1),
                       b if b.ndim == 1 else b[:, 3:].sum(1)) == 1.0, name
            np.testing.assert_array_equal(a[..., :3] if a.ndim > 1 else 0,
                                          b[..., :3] if b.ndim > 1 else 0)
        elif name.endswith("_edge.txt"):
            np.testing.assert_allclose(a, b, atol=1.01e-4)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_run_prediction_refuses_what_is_not_ported(h5_root, monkeypatch):
    cfg = cfg_port.Config(**_cli_config(h5_root, ""))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        predict_port.run_prediction(cfg, data_root=h5_root, mesh_devices=2,
                                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_port.run_prediction(cfg, data_root=h5_root)


# --- main --------------------------------------------------------------------

ARGVS = [[], ["NoSave"], ["Save", "multi_vote"],
         ["Save", "multi_vote", "fold5drop"],
         ["NoSave", "x", "fold5drop", "postproc"],
         ["postproc", "--starts", "3", "--batch-size", "2"],
         ["--mesh", "4", "NoSave", "multi_vote", "fold5drop"]]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "cfg"
                                             for a in ARGVS])
def test_main_passes_jax_flags(argv, monkeypatch):
    # JAX's main would turn on its persistent compilation cache
    monkeypatch.setenv("SEDNET_TPU_NO_CACHE", "1")
    calls = {}

    def record(name):
        def run(cfg, **kw):
            calls[name] = (cfg.asdict(), kw)
        return run

    monkeypatch.setattr(predict_jax, "run_prediction", record("jax"))
    monkeypatch.setattr(predict_port, "run_prediction", record("port"))
    path = os.path.join(ROOT, "configs", "config_SEDNet_normal_test.yml")
    predict_jax.main([path] + argv)
    predict_port.main([path] + argv)
    assert calls["port"] == calls["jax"]


# --- the async/finalize split and the stream ---------------------------------

def _blobs(rng, b=3, n=200, e=16, k=5, noise=0.05):
    out = []
    for _ in range(b):
        centers = rng.randn(k, e)
        x = centers[rng.randint(0, k, n)] + noise * rng.randn(n, e)
        out.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    return np.stack(out).astype(np.float32)


def _parent_cluster_batch(x, *, num_samples, quantile, iterations,
                          max_clusters, retry_factor, tol, sels):
    """cluster_batch as one call with the shift loop's host read and early
    break (`_iterate_until`), as it stood before the async/finalize split.
    Returns its outputs and the shift steps it ran."""
    b = x.shape[0]
    x = ms.kernel_width(x)
    sels = [s if isinstance(s, (list, tuple)) else [s] for s in sels]
    bw = torch.stack([torch.clamp_min(ms.compute_bandwidth(
        x[i], num_samples, np.float32(quantile), sel=sels[i][0]),
        ms._MIN_BANDWIDTH) for i in range(b)])
    steps = []

    def step(cur):
        steps.append(1)
        return ms.mean_shift_step_batched(cur, x, bw)

    shifted = ms._iterate_until(step, x, iterations, tol)
    bw_host = bw.tolist()
    labels, nums = [], []
    capped, bw_capped = np.zeros((b,), bool), np.zeros((b,), bool)
    for i in range(b):
        lab, mask, num = ms.nms(shifted[i], x[i], bw_host[i])
        if num > max_clusters:
            first = ms.MeanShiftResult(shifted[i], lab, mask, num, bw_host[i],
                                       np.float32(quantile))
            attempt = ms._attempts(x[i], sels[i], num_samples=num_samples,
                                   iterations=iterations, tol=tol,
                                   generator=None)
            res = ms._guarded(x[i], x.shape[-1], first, attempt,
                              num_samples=num_samples,
                              max_clusters=max_clusters,
                              retry_factor=retry_factor)
            lab, num = res.labels, res.num_clusters
            capped[i], bw_capped[i] = res.capped, res.bw_capped
        labels.append(lab)
        nums.append(num)
    return (torch.stack(labels), nums, capped, bw_capped), len(steps)


# cluster_batch through its async half (the tol exit as a done flag on the
# device, every step run) and its finalize half equals the loop that read
# the movement back and broke: label for label, with the exit firing early
# (tight blobs), never (tol 0), and with guarded retries (max_clusters 2).
@pytest.mark.parametrize("noise,tol,max_clusters,early", [
    (0.02, 1e-6, 49, True), (0.02, 0.0, 49, False), (0.02, 1e-6, 2, None)])
def test_cluster_batch_async_finalize_matches_parent_loop(noise, tol,
                                                          max_clusters,
                                                          early):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(_blobs(rng, noise=noise))
    gen = torch.Generator().manual_seed(0)
    sels = [[torch.randperm(200, generator=gen)[:150] for _ in range(17)]
            for _ in range(3)]
    kw = dict(num_samples=150, quantile=0.015, iterations=50,
              max_clusters=max_clusters, retry_factor=1.2, tol=tol)
    (want_l, want_n, want_c, want_bc), steps = _parent_cluster_batch(
        x, sels=sels, **kw)
    if early is not None:
        assert (steps < 50) == early, steps
    pending = ms.cluster_batch_async(
        x, sels=sels, **{k: kw[k] for k in ("num_samples", "quantile",
                                            "iterations", "tol")})
    got_l, got_n, flags = ms.cluster_batch_finalize(pending, **kw)
    np.testing.assert_array_equal(got_l.numpy(), want_l.numpy())
    assert got_n.tolist() == want_n
    np.testing.assert_array_equal(flags["capped"], want_c)
    np.testing.assert_array_equal(flags["bw_capped"], want_bc)
    if max_clusters == 2:  # five blobs a shape: every shape retried
        assert max(want_n) <= 2
    labels, nums, flags2 = ms.cluster_batch(x, sels=sels, **kw)
    np.testing.assert_array_equal(labels.numpy(), want_l.numpy())


# The port's cluster_batch against the JAX package's (its batched Pallas
# step in interpret mode), both with JAX's bandwidth subsamples: the same
# partitions and cluster counts, with the tol exit on.
def test_cluster_batch_matches_jax_cluster_batch(monkeypatch):
    from sednet_tpu.cluster.mean_shift import cluster_batch as cb_jax
    from sednet_tpu.ops import pallas_kernels

    monkeypatch.setattr(
        pallas_kernels, "mean_shift_step_pallas_batched",
        functools.partial(pallas_kernels.mean_shift_step_pallas_batched,
                          row_block=64, col_block=128, interpret=True))
    x = _blobs(np.random.RandomState(2), n=192)
    key = jax.random.PRNGKey(5)
    want_l, want_n, want_f = cb_jax(key, jnp.asarray(x), num_samples=150,
                                    iterations=50)
    keys = jax.random.split(key, 3)
    sels = [torch.from_numpy(np.array(jax.random.permutation(k, 192)[:150]))
            for k in keys]
    got_l, got_n, got_f = ms.cluster_batch(torch.from_numpy(x),
                                           num_samples=150, sels=sels)
    for i in range(3):
        assert ari(got_l[i].numpy(), np.asarray(want_l[i])) == 1.0
    assert got_n.tolist() == np.asarray(want_n).tolist()
    assert not got_f["capped"].any() and not np.asarray(want_f["capped"]).any()


# The stream (batch k+1's device half before batch k's host half) gives
# each batch what predict_shapes gives it with the batch's generator, with
# HPNet enrichment on (its LOBPCG start blocks come from that generator).
def test_predict_shapes_stream_matches_per_batch():
    shapes, _ = predict_port.headline_shapes(4, N)
    batches = [{k: np.stack([s[k] for s in shapes[i:i + 2]])
                for k in ("points", "normals", "labels", "prim")}
               for i in (0, 2)]
    cfg = cfg_port.Config(num_points=N, knn=16, hpnet_embed=True)
    models = predict_port.load_models(CKPT, cfg, device="cpu")
    streamed = list(predict_port.predict_shapes_stream(
        models["type"], models["inst"], iter(batches), cfg, seed=11))
    assert len(streamed) == 2
    for k, batch in enumerate(batches):
        want = predict_port.predict_shapes(
            models["type"], models["inst"], batch, cfg,
            generator=predict_port.batch_generator(11, k))
        for g, w in zip(streamed[k], want):
            assert g.keys() == w.keys()
            for name in g:
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)
