"""The port's serving path (sednet_tpu_torch.export, serve, utils.tracing)
against the JAX package's on the CPU, at N 136, k 8, embed 16, B 2, on
JAX's init parameters: the exported bundle's forward against the port's
own (1e-6) and against JAX's `load_bundle` (atol 1e-4); the `sednet::`
ops in the exported graph; meta.json; the export CLI; a load on the wrong
device; the counterparts of `tests/test_serve.py` against JAX's
`BundleServer` (types and edges equal outside near-ties; cluster labels
against the port's own `guard_mean_shift` with the same generators); the
tracing helpers."""
import dataclasses
import io
import json
import logging
import os
import shutil
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.export import export_serving_bundle as jax_export_bundle
from sednet_tpu.export import load_bundle as jax_load_bundle
from sednet_tpu.serve import BundleServer as JaxBundleServer
from sednet_tpu.train import build_model as jax_build_model
from sednet_tpu_torch import export, serve
from sednet_tpu_torch.cluster.mean_shift import guard_mean_shift
from sednet_tpu_torch.cluster.spectral import hpnet_process
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.predict import spectral_embed
from sednet_tpu_torch.train import build_model
from sednet_tpu_torch.utils import tracing
from sednet_tpu_torch.weights import flatten_tree, params_from_flat

N, K = 136, 8
CFG_KW = dict(num_points=N, knn=K, embed=16, batch_size=2, ms_num_samples=N)
FIELDS = ("embedding", "type_log_prob", "type_logits", "edge_logits")
NEAR_TIE = 1e-5   # rows whose top two logits lie closer may argmax apart


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """JAX's bundle (platforms cpu) and the port's (device cpu) of one
    model on JAX's init parameters, as both type and inst model."""
    jcfg = JaxConfig(**CFG_KW)
    jmodel = jax_build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((2, N, 6)))["params"]
    jdir = str(tmp_path_factory.mktemp("jax_bundle"))
    jax_export_bundle(jcfg, params, params, jdir, platforms=["cpu"])
    sd = params_from_flat(flatten_tree(params), "")
    cfg = Config(**CFG_KW)
    tdir = str(tmp_path_factory.mktemp("port_bundle"))
    export.export_serving_bundle(cfg, sd, sd, tdir, device="cpu")
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    return dict(jdir=jdir, tdir=tdir, model=model.eval(), params=params,
                cfg=cfg, sd=sd)


def _cloud(seed, n=N):
    pts = np.random.RandomState(seed).randn(n, 6).astype(np.float32)
    pts[:, 3:] /= np.linalg.norm(pts[:, 3:], axis=1, keepdims=True)
    return pts


def test_bundle_round_trip_matches_forward_and_jax(bundles):
    x = np.stack([_cloud(0), _cloud(1)])
    meta, fns = export.load_bundle(bundles["tdir"], device="cpu")
    assert set(fns) == {"type_model", "inst_model"}
    with torch.no_grad():
        got = fns["type_model"](torch.from_numpy(x))
        ref = bundles["model"](torch.from_numpy(x))
    _, jfns = jax_load_bundle(bundles["jdir"])
    want = jfns["type_model"](jnp.asarray(x))
    assert set(got) == set(want) == set(FIELDS)   # JAX's keys
    for name in FIELDS:
        np.testing.assert_allclose(got[name].numpy(),
                                   getattr(ref, name).numpy(), atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)


def test_exported_graph_calls_the_kernel_ops(bundles):
    """The counterpart of test_tpu_export_from_cpu_host_embeds_pallas: the
    saved program calls K1 and K6 as `sednet::` ops (three kNN graphs,
    three gather-reduces), so on the card it launches the kernels."""
    for name in ("type_model", "inst_model"):
        ep = torch.export.load(os.path.join(bundles["tdir"], f"{name}.pt2"))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("sednet.topk.default") == 3
        assert targets.count("sednet.gather_reduce.default") == 3


def test_meta_json_keys(bundles):
    with open(os.path.join(bundles["tdir"], "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"torch_version", "config", "models"}
    assert meta["torch_version"] == torch.__version__
    assert meta["config"] == bundles["cfg"].asdict()
    for name in ("type_model", "inst_model"):
        m = meta["models"][name]
        assert set(m) == {"file", "device", "in_avals", "out_avals"}
        assert m["file"] == f"{name}.pt2" and m["device"] == "cpu"
        assert m["in_avals"] == [f"float32[2,{N},6]"]
        assert m["out_avals"] == [f"float32[2,{N},16]", f"float32[2,{N},6]",
                                  f"float32[2,{N},6]", f"float32[2,{N},2]"]
    with open(os.path.join(bundles["jdir"], "meta.json")) as f:
        jmeta = json.load(f)
    assert (jmeta["models"]["type_model"]["in_avals"][0]
            == meta["models"]["type_model"]["in_avals"][0])


def test_export_cli(bundles, tmp_path):
    from sednet_tpu_torch.weights import save_params_npz

    cfg_path = str(tmp_path / "cfg.json")
    bundles["cfg"].save(cfg_path)
    ck = str(tmp_path / "ck.npz")
    save_params_npz(ck, bundles["model"])
    out = str(tmp_path / "bundle_cli")
    export.main([cfg_path, "--type-ckpt", ck, "--inst-ckpt", ck, "--out", out,
                 "--batch", "2", "--device", "cpu"])
    _, fns = export.load_bundle(out, device="cpu")
    x = torch.from_numpy(np.stack([_cloud(2), _cloud(3)]))
    res = fns["inst_model"](x)
    assert res["embedding"].shape == (2, N, 16)
    with torch.no_grad():
        ref = bundles["model"](x)
    np.testing.assert_allclose(res["embedding"].detach().numpy(),
                               ref.embedding.numpy(), atol=1e-6)


def test_load_on_another_device_raises(bundles, tmp_path, monkeypatch):
    d = str(tmp_path / "bundle")
    shutil.copytree(bundles["tdir"], d)
    meta_path = os.path.join(d, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["models"]["inst_model"]["device"] = "cuda"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="exported for cuda"):
        export.load_bundle(d, device="cpu")
    # the default is the card: without one, loading raises, not falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_bundle(bundles["tdir"])


# --- the server -----------------------------------------------------------------

def _argmax_equal_outside_ties(got, want_logits):
    """got (n,) labels against the argmax of want_logits (n, C), rows whose
    top two logits lie within NEAR_TIE exempt."""
    top2 = np.sort(want_logits, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > NEAR_TIE
    np.testing.assert_array_equal(np.asarray(got)[sure],
                                  want_logits.argmax(-1)[sure])
    assert sure.mean() > 0.9


def test_server_pads_and_slices(bundles):
    srv = serve.BundleServer(bundles["tdir"], device="cpu")
    jsrv = JaxBundleServer(bundles["jdir"])
    short, full = _cloud(4)[:N - 30], _cloud(5)
    out = srv.predict([short, full])
    jout = jsrv.predict([short, full])
    assert len(out) == 2
    assert len(out[0]["types"]) == N - 30 and len(out[1]["types"]) == N
    x, lengths = srv._pad([short, full])
    jx, jlengths = jsrv._pad([short, full])
    np.testing.assert_array_equal(x, jx)
    assert lengths == jlengths
    _, jfns = jax_load_bundle(bundles["jdir"])
    jres = jfns["type_model"](jnp.asarray(x))
    for i, n in enumerate(lengths):
        for key, field in (("types", "type_log_prob"),
                           ("edges", "edge_logits")):
            assert len(out[i][key]) == len(jout[i][key]) == n
            _argmax_equal_outside_ties(out[i][key],
                                       np.asarray(jres[field][i, :n]))
    # the full-length shape against a direct forward of the port's model
    with torch.no_grad():
        ref = bundles["model"](torch.from_numpy(full)[None])
    _argmax_equal_outside_ties(out[1]["types"],
                               ref.type_log_prob[0].numpy())


def _own_labels(srv, x, n, gen):
    """The port's own clustering of a padded request's first shape (its
    real-length slice) with the generator the server draws for it."""
    _, fns = export.load_bundle(srv.bundle_dir, device="cpu")
    with torch.no_grad():
        emb = fns["inst_model"](torch.from_numpy(x))["embedding"][0, :n]
    xt = torch.from_numpy(x)
    v, ent = spectral_embed(xt[0, :n, :3], xt[0, :n, 3:6], srv.cfg,
                            generator=gen)
    emb = hpnet_process(emb, xt[0, :n, :3], xt[0, :n, 3:6],
                        normal_smooth_w=srv.cfg.normal_smooth_w,
                        cached_eigvecs=v, cached_eig_entropy=ent)
    emb = emb / torch.clamp_min(emb.norm(dim=-1, keepdim=True), 1e-12)
    cfg = srv.cfg
    return guard_mean_shift(
        emb, num_samples=min(cfg.ms_num_samples, n), quantile=cfg.ms_quantile,
        iterations=cfg.ms_iterations, max_clusters=cfg.ms_max_clusters - 1,
        retry_factor=cfg.ms_retry_factor, tol=cfg.ms_tol, generator=gen)


def test_server_cluster_labels(bundles):
    srv = serve.BundleServer(bundles["tdir"], cluster=True, device="cpu")
    pts = _cloud(1)
    gens = torch.Generator().manual_seed(0)   # the server's own seed
    for n in (N, N - 40):   # short cloud: the real slice only
        out = srv.predict([pts[:n]])
        x, _ = srv._pad([pts[:n]])
        want = _own_labels(srv, x, n, serve.request_generators(gens, 1)[0])
        assert len(out[0]["instances"]) == n
        assert out[0]["num_instances"] == want.num_clusters >= 1
        assert out[0]["instances"] == want.labels.tolist()
    # JAX's server on the same request: lengths and the types agree
    jout = JaxBundleServer(bundles["jdir"], cluster=True).predict([pts])
    assert len(jout[0]["instances"]) == N
    _argmax_equal_outside_ties(
        srv.predict([pts])[0]["types"],
        np.asarray(jax_load_bundle(bundles["jdir"])[1]["type_model"](
            jnp.asarray(srv._pad([pts])[0]))["type_log_prob"][0]))


def test_server_rejects_bad_requests(bundles):
    srv = serve.BundleServer(bundles["tdir"], device="cpu")
    jsrv = JaxBundleServer(bundles["jdir"])
    pts = np.zeros((N, 6), np.float32)
    for bad in ([pts, pts, pts], [np.zeros((N + 1, 6), np.float32)],
                [np.zeros((0, 6), np.float32)], [np.zeros((N, 3), np.float32)]):
        with pytest.raises(ValueError) as got:
            srv.predict(bad)
        with pytest.raises(ValueError) as want:
            jsrv.predict(bad)
        assert str(got.value) == str(want.value)


def test_http_round_trip(bundles, capsys):
    srv = serve.BundleServer(bundles["tdir"], device="cpu")
    httpd = serve.make_http_server(srv, port=0)   # ephemeral port
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{url}/health") as r:
            h = json.loads(r.read())
        assert h == {"ok": True, "batch": 2, "num_points": N, "channels": 6}
        logged = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(logged["launches"]) == {"K1", "K2", "K2b", "K3", "K4",
                                           "K5", "K6", "K6b"}

        pts = _cloud(2)
        req = urllib.request.Request(
            f"{url}/predict", data=json.dumps({"points": pts.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            res = json.loads(r.read())
        assert len(res["results"][0]["types"]) == N
        assert res["results"] == srv.predict([pts])

        buf = io.BytesIO()
        np.savez(buf, points=pts[None])
        req = urllib.request.Request(
            f"{url}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req) as r:
            res2 = json.loads(r.read())
        assert res2["results"][0]["types"] == res["results"][0]["types"]

        # ragged shapes in one npz: "lengths" cuts each to its own
        buf = io.BytesIO()
        np.savez(buf, points=np.stack([pts, _cloud(3)]),
                 lengths=np.array([N, N - 36]))
        req = urllib.request.Request(
            f"{url}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req) as r:
            res3 = json.loads(r.read())["results"]
        assert res3 == srv.predict([pts, _cloud(3)[:N - 36]])
        assert [len(r["types"]) for r in res3] == [N, N - 36]

        for path, body, code in (("/predict", b"{not json", 400),
                                 ("/nowhere", b"{}", 404)):
            req = urllib.request.Request(
                f"{url}{path}", data=body,
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            assert err.value.code == code
    finally:
        httpd.shutdown()
        httpd.server_close()


# --- tracing -------------------------------------------------------------------

def test_tracing_helpers(tmp_path, caplog):
    timings = {}
    with tracing.trace("stage", timings):
        pass
    with tracing.trace("stage", timings, log=True):
        pass
    assert set(timings) == {"stage"} and timings["stage"] >= 0.0

    tracing.check_finite({"a": torch.ones(3), "b": [np.ones(2), 1.0],
                          "c": torch.arange(3)}, "ok")
    with pytest.raises(FloatingPointError,
                       match=r"bad\['b'\]\[1\]: nan=1, inf=2"):
        tracing.check_finite({"a": torch.ones(2), "b": [
            torch.zeros(1), torch.tensor([np.nan, np.inf, -np.inf])]}, "bad")

    with caplog.at_level(logging.ERROR, logger="sednet_tpu_torch.trace"):
        x = torch.tensor([1.0, np.nan])
        assert tracing.debug_assert_finite(x, "x") is x
    assert "non-finite values in x: 1" in caplog.text

    tracing.start_profile(str(tmp_path / "prof"))
    with pytest.raises(RuntimeError):
        tracing.start_profile(str(tmp_path / "prof"))
    with tracing.trace("profiled"):
        torch.ones(8).sum()
    path = tracing.stop_profile()
    with open(path) as f:
        assert "profiled" in f.read()
    with pytest.raises(RuntimeError):
        tracing.stop_profile()


def test_server_config_snapshot_is_the_bundles(bundles):
    srv = serve.BundleServer(bundles["tdir"], device="cpu")
    assert dataclasses.asdict(srv.cfg) == bundles["cfg"].asdict()
    assert (srv.batch, srv.num_points, srv.channels) == (2, N, 6)
