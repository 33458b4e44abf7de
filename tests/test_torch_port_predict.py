"""The port's reference-default eval (sednet_tpu_torch.predict
.predict_shapes: type-model TTA, HPNet enrichment, cluster_batch and the
chamfer-recall metrics) against the JAX package on the CPU, with JAX's own
random inputs (each shape's LOBPCG start block and bandwidth subsamples)
handed to the port."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.metrics.segmentation import \
    siou_matched_segments_usecd as usecd_one_jax
from sednet_tpu.metrics.segmentation import \
    siou_matched_segments_usecd_batch as usecd_jax
from sednet_tpu.ops.chamfer import chamfer_distance as chamfer_jax
from sednet_tpu.ops.chamfer import nn_distance as nn_jax
from sednet_tpu.predict import make_tta_type_log_prob as tta_jax
from sednet_tpu.predict import predict_shapes as predict_jax
from sednet_tpu.train import build_model, load_params
from sednet_tpu_torch.config import Config, load_config
from sednet_tpu_torch.metrics import (siou_matched_segments_usecd,
                                      siou_matched_segments_usecd_batch,
                                      to_one_hot)
from sednet_tpu_torch.ops.chamfer import (chamfer_distance, chamfer_index,
                                          nn_distance)
from sednet_tpu_torch.predict import (SpectralCache, headline_shapes,
                                      load_models, make_tta_type_log_prob,
                                      predict_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "bench_10k.npz")
N = 384


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


@pytest.fixture(scope="module")
def shapes():
    sh, _ = headline_shapes(2, N)
    batch = {k: np.stack([s[k] for s in sh])
             for k in ("points", "normals", "labels", "prim")}
    return sh, batch


def test_chamfer_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 150, 3)).astype(np.float32)
    y = rng.standard_normal((2, 90, 3)).astype(np.float32)
    d1j, d2j, i1j, i2j = nn_jax(jnp.asarray(x), jnp.asarray(y), row_block=64)
    d1, d2, i1, i2 = nn_distance(torch.from_numpy(x), torch.from_numpy(y),
                                 row_block=64)
    for got, want in ((d1, d1j), (d2, d2j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i1j))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i2j))
    c1, c2 = chamfer_index(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(c1.numpy(), d1.numpy())
    for sq in (False, True):
        np.testing.assert_allclose(
            float(chamfer_distance(torch.from_numpy(x), torch.from_numpy(y),
                                   sqrt=sq)),
            float(chamfer_jax(jnp.asarray(x), jnp.asarray(y), sqrt=sq)),
            rtol=1e-5)


def _noisy_labels(shape, rng, flip=0.1):
    """The true labels with a share of points moved to a random segment and
    one segment split in two (a small one: usecd keeps it)."""
    lab = shape["labels"].astype(np.int64).copy()
    move = rng.random(lab.shape[0]) < flip
    lab[move] = rng.integers(0, lab.max() + 1, move.sum())
    first = np.flatnonzero(lab == 0)
    lab[first[:len(first) // 3]] = lab.max() + 1
    return lab


# Same labels, same points: the Hungarian matching, the IoUs and the
# chamfer recall (distances thresholded at 0.1) are identical.
def test_usecd_metrics_match_jax(shapes):
    sh, batch = shapes
    rng = np.random.default_rng(1)
    preds = [_noisy_labels(s, rng) for s in sh]
    types = [np.where(rng.random(N) < 0.2, rng.integers(0, 6, N), s["prim"])
             for s in sh]
    args = ([s["labels"].astype(np.int64) for s in sh], preds, types,
            [s["prim"].astype(np.int64) for s in sh], list(batch["points"]))
    want = usecd_jax(*args)
    got = siou_matched_segments_usecd_batch(*args)
    for g, w in zip(got, want):
        for idx in (0, 1, 4):
            assert g[idx] == pytest.approx(w[idx], abs=1e-12)
        np.testing.assert_array_equal(g[2][0], w[2][0])
        np.testing.assert_array_equal(g[2][1], w[2][1])
    one_args = (args[0][0], preds[0], types[0], args[3][0],
                to_one_hot(preds[0], int(preds[0].max()) + 1), args[4][0])
    g1, w1 = siou_matched_segments_usecd(*one_args), usecd_one_jax(*one_args)
    assert (g1[0], g1[1], g1[4]) == pytest.approx((w1[0], w1[1], w1[4]))


@pytest.fixture(scope="module")
def type_models():
    cfg = JaxConfig(num_points=N, knn=16, embed=128)
    params = load_params(CKPT)
    model = load_models(CKPT, Config(knn=16), device="cpu",
                        which=("type",))["type"]
    return build_model(cfg), params["type"], cfg, model


# TTA votes on the trained type weights, folds of 128 points (the
# reference's 2000 is larger than these clouds): the same log-prob sums to
# float association through up to 7 forwards.
@pytest.mark.parametrize("multi_vote,fold5drop", [(True, False),
                                                  (False, True),
                                                  (True, True)])
def test_tta_variants_match_jax(shapes, type_models, multi_vote, fold5drop):
    _, batch = shapes
    jmodel, params, jcfg, model = type_models
    x = np.concatenate([batch["points"], batch["normals"]], -1)[:1]
    want = tta_jax(jmodel, jcfg, multi_vote, fold5drop, drop_num=128)(
        params, jnp.asarray(x))
    got = make_tta_type_log_prob(model, Config(knn=16), multi_vote,
                                 fold5drop, drop_num=128)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))


def _jax_inputs(key, b, n, m, eig_k=12, attempts=17):
    """The LOBPCG start block and the per-attempt bandwidth subsamples that
    JAX's predict_shapes draws for each shape on the CPU."""
    x0s, sels = [], []
    for i in range(b):
        x0s.append(np.array(jax.random.normal(jax.random.fold_in(key, i),
                                              (n, eig_k), jnp.float32)))
        k = jax.random.fold_in(key, 1000 + i)
        per = []
        for _ in range(attempts):
            k, sub = jax.random.split(k)
            per.append(torch.from_numpy(
                np.array(jax.random.permutation(sub, n)[:m])))
        sels.append(per)
    return x0s, sels


KW = dict(num_points=N, knn=16, embed=128, hpnet_embed=True,
          ms_num_samples=5000, ms_tol=0.0)


@pytest.fixture(scope="module")
def jax_predicted(shapes, tmp_path_factory):
    """JAX's predict_shapes on the two shapes (no tol exit: ms_tol=0, so
    the JAX CPU path's per-shape clustering and the port's batched one run
    the same 50 steps), its random inputs, and a spectral cache holding
    the eigenvectors JAX's solve gives for each shape."""
    from sednet_tpu.predict import spectral_embed as spectral_embed_jax

    _, batch = shapes
    jcfg = JaxConfig(**KW)
    params = load_params(CKPT)
    key = jax.random.PRNGKey(7)
    want = predict_jax(build_model(jcfg), params["type"], params["inst"],
                       batch, jcfg, key=key)
    cache = SpectralCache(str(tmp_path_factory.mktemp("spectral")),
                          jcfg.spectral_sigma, jcfg.spectral_knn)
    for i in range(2):
        v, ent = spectral_embed_jax(
            jnp.asarray(batch["points"][i]), jnp.asarray(batch["normals"][i]),
            jcfg, key=jax.random.fold_in(key, i))
        cache.put(i, torch.from_numpy(np.array(v)),
                  torch.from_numpy(np.array(ent)))
    return want, cache, _jax_inputs(key, 2, N, N)


# The reference-default eval at N=384 (k=16) on the trained weights, with
# JAX's bandwidth subsamples and JAX's eigenvectors (through the spectral
# cache): the same partitions, cluster counts, types and usecd metrics,
# with the index forward and with the fused encoder.
@pytest.mark.parametrize("fused", [False, True])
def test_predict_shapes_matches_jax(shapes, jax_predicted, fused):
    _, batch = shapes
    want, cache, (x0s, sels) = jax_predicted
    cfg = Config(**KW, fused_encoder=fused)
    models = load_models(CKPT, cfg, device="cpu")
    got = predict_shapes(models["type"], models["inst"], batch, cfg,
                         cache=cache, shape_ids=[0, 1], sels=sels)
    for g, w in zip(got, want):
        assert ari(g["cluster_ids"], w["cluster_ids"]) == 1.0
        assert g["num_clusters"] == w["num_clusters"]
        for name in ("inst_iou", "type_iou", "inst_recall"):
            assert g[name] == pytest.approx(w[name], abs=1e-12), name
        np.testing.assert_array_equal(g["pred_primitives"],
                                      w["pred_primitives"])
        np.testing.assert_allclose(g["edge_prob"], w["edge_prob"], atol=1e-4)
        assert not g["guard_capped"] and not g["guard_bw_capped"]


# The same eval with the port's own LOBPCG from JAX's start block: the
# 10-iteration solve does not converge, and the row normalisation of the
# eigenvectors divides rows of norm ~1e-6, so float32 rounding of the two
# solves moves the enriched embedding (see test_torch_port_spectral.py).
# Measured (port vs JAX): shape 0 identical (ARI 1.0, 5 clusters, inst_iou
# 0.78136, type_iou 0.8, recall 0.8333); shape 1 at ARI 0.977 (10
# clusters, inst_iou 0.80913 vs 0.80106, a gap of 0.0081; type_iou 0.8333
# and recall 1.0 in both). So counts, recall and type IoU are held exact,
# inst_iou at 0.02, about twice the measured gap.
def test_predict_shapes_from_jax_start_block(shapes, jax_predicted):
    _, batch = shapes
    want, _, (x0s, sels) = jax_predicted
    cfg = Config(**KW)
    models = load_models(CKPT, cfg, device="cpu")
    got = predict_shapes(models["type"], models["inst"], batch, cfg,
                         x0s=x0s, sels=sels)
    for g, w in zip(got, want):
        assert ari(g["cluster_ids"], w["cluster_ids"]) >= 0.95
        assert g["num_clusters"] == w["num_clusters"]
        assert g["inst_iou"] == pytest.approx(w["inst_iou"], abs=0.02)
        assert g["inst_recall"] == pytest.approx(w["inst_recall"], abs=1e-12)
        assert g["type_iou"] == pytest.approx(w["type_iou"], abs=1e-12)


def test_load_config_reads_jax_config_files(tmp_path):
    from sednet_tpu.config import load_config as load_jax

    for name in ("config_SEDNet_normal.yml", "config_test_tiny.yml"):
        path = os.path.join(ROOT, "configs", name)
        cfg, want = load_config(path), load_jax(path)
        for f in Config.__dataclass_fields__:
            assert getattr(cfg, f) == getattr(want, f), (name, f)
    path = tmp_path / "c.json"
    path.write_text('{"knn": 16, "hpnet_embed": false, "lr": 0.1, '
                    '"not_a_field": 3}')
    assert load_config(str(path)) == Config(knn=16, hpnet_embed=False, lr=0.1)
