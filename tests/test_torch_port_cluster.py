"""The port's clustering and the whole inference slice against the JAX
package on the CPU. JAX draws its bandwidth subsamples with
jax.random.permutation, which torch cannot reproduce, so these tests hand
JAX's indices to the port through `sel`."""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.cluster import guard_mean_shift as guard_jax
from sednet_tpu.cluster.mean_shift import mean_shift_iterate as iterate_jax
from sednet_tpu.cluster.mean_shift import nms as nms_jax
from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.train import build_model, load_params
from sednet_tpu_torch.cluster import (cluster_batch, compute_bandwidth,
                                      guard_mean_shift, nms)
from sednet_tpu_torch.cluster.mean_shift import bandwidth_k
from sednet_tpu_torch.metrics import batch_iou
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.predict import (HEADLINE, cluster_settings,
                                      headline_shapes, load_models,
                                      segment_batch)

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "bench_10k.npz")


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


def same_partition(a, b):
    return ari(a, b) == 1.0


def _clustered(rng, n=400, e=16, k=6, noise=0.15):
    centers = rng.randn(k, e)
    x = centers[rng.randint(0, k, n)] + noise * rng.randn(n, e)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _jax_sels(key, n, m, attempts=17):
    """The subsample indices guard_mean_shift draws on each attempt."""
    sels = []
    for _ in range(attempts):
        key, sub = jax.random.split(key)
        sels.append(torch.from_numpy(
            np.array(jax.random.permutation(sub, n)[:m])))
    return sels


def test_bandwidth_k_is_float32():
    # f32(0.015) * 5000 = 74.99999 -> 74 in float32 (75 in float64)
    assert bandwidth_k(np.float32(0.015), 5000) == int(
        np.float32(0.015) * np.float32(5000))
    assert bandwidth_k(0.9, 300) == 256 and bandwidth_k(1e-6, 300) == 1


@pytest.mark.parametrize("quantile", [0.05, 0.6])  # top-k and dense branches
def test_compute_bandwidth_matches_jax(rng, quantile):
    from sednet_tpu.cluster.mean_shift import compute_bandwidth as bw_jax

    x = _clustered(rng, n=400)
    key = jax.random.PRNGKey(3)
    want = bw_jax(key, jnp.asarray(x), 300, jnp.float32(quantile))
    sel = torch.from_numpy(np.array(jax.random.permutation(key, 400)[:300]))
    got = compute_bandwidth(torch.from_numpy(x), 300, quantile, sel=sel)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_nms_matches_jax_on_exact_ties(rng):
    # centers snapped onto 6 exact representatives (plus a few loners):
    # every membership and vote is an exact tie that the lowest-index rule
    # settles, so labels and the center mask must be identical
    x = _clustered(rng)
    reps = _clustered(rng, n=6)
    centers = reps[rng.randint(0, 6, 400)]
    centers[::37] = x[::37]
    want, mask_j, num_j = nms_jax(jnp.asarray(centers), jnp.asarray(x),
                                  jnp.float32(0.3))
    got, mask, num = nms(torch.from_numpy(centers), torch.from_numpy(x), 0.3)
    assert num == int(num_j)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nms_matches_jax_on_shifted_centers(rng):
    # converged centers coincide only up to rounding, which differs between
    # the two packages' matmuls; which duplicate survives may differ, the
    # partition may not
    x = _clustered(rng)
    shifted = iterate_jax(jnp.asarray(x), jnp.float32(0.3), 20)
    want, _, num_j = nms_jax(shifted, jnp.asarray(x), jnp.float32(0.3))
    got, _, num = nms(torch.from_numpy(np.array(shifted)),
                      torch.from_numpy(x), 0.3)
    assert num == int(num_j)
    assert same_partition(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_clusters", [49, 3])  # 3 forces retries + cap
def test_guard_mean_shift_matches_jax(rng, max_clusters):
    x = _clustered(rng)
    key = jax.random.PRNGKey(7)
    want = guard_jax(key, jnp.asarray(x), num_samples=300, quantile=0.015,
                     iterations=50, max_clusters=max_clusters)
    got = guard_mean_shift(torch.from_numpy(x), num_samples=300,
                           quantile=0.015, iterations=50,
                           max_clusters=max_clusters,
                           sel=_jax_sels(key, 400, 300))
    assert got.tries == int(want.tries)
    assert got.num_clusters == int(want.num_clusters)
    assert got.capped == bool(want.capped)
    np.testing.assert_allclose(got.bandwidth, float(want.bandwidth),
                               rtol=1e-5)
    assert same_partition(got.labels.numpy(), np.asarray(want.labels))


def test_guard_mean_shift_with_fixed_bandwidth(rng):
    x = _clustered(rng)
    want = guard_jax(jax.random.PRNGKey(0), jnp.asarray(x), num_samples=300,
                     iterations=50)
    got = guard_mean_shift(torch.from_numpy(x), num_samples=300,
                           bandwidth=float(want.bandwidth))
    assert same_partition(got.labels.numpy(), np.asarray(want.labels))


def test_cluster_batch_agrees_with_per_shape(rng):
    x = np.stack([_clustered(rng) for _ in range(3)])
    sels = [torch.randperm(400, generator=torch.Generator().manual_seed(i))
            [:300] for i in range(3)]
    labels, nums, flags = cluster_batch(torch.from_numpy(x), num_samples=300,
                                        sels=sels)
    assert labels.shape == (3, 400) and not flags["capped"].any()
    for i in range(3):
        one = guard_mean_shift(torch.from_numpy(x[i]), num_samples=300,
                               sel=sels[i])
        assert int(nums[i]) == one.num_clusters
        assert ari(labels[i].numpy(), one.labels.numpy()) >= 0.99


# The whole slice at N=512 on the trained inst weights: the same shapes and
# the same bandwidth subsamples through both packages' forward + guarded
# mean-shift. Partitions agree at ARI >= 0.99 (float association in the
# forward may move a point or two across a boundary).
def test_slice_matches_jax_pipeline():
    n = 512
    _, x = headline_shapes(2, n)
    jmodel = build_model(JaxConfig(num_points=n, knn=64, embed=128))
    variables = {"params": load_params(CKPT)["inst"]}
    out = jmodel.apply(variables, jnp.asarray(x))
    emb = out.embedding / jnp.clip(
        jnp.linalg.norm(out.embedding, axis=-1, keepdims=True), min=1e-12)
    key = jax.random.PRNGKey(1)

    model = load_models(CKPT, device="cpu", which=("inst",))["inst"]
    for i in range(2):
        k = jax.random.fold_in(key, i)
        want = guard_jax(k, emb[i], num_samples=5000, quantile=0.015,
                         iterations=50)
        labels, types = segment_batch(model, torch.from_numpy(x[i:i + 1]),
                                      sel=_jax_sels(k, n, n))
        assert ari(labels[0].numpy(), np.asarray(want.labels)) >= 0.99
        np.testing.assert_array_equal(
            types[0].numpy(), np.asarray(out.type_log_prob[i]).argmax(-1))


# The port's Config keeps the JAX Config's ms_* defaults, and HEADLINE maps
# to what bench.py's cluster_one passes (5000 samples, quantile 0.015, 50
# iterations) plus the JAX guard_mean_shift defaults it leaves alone.
def test_headline_cluster_settings_match_jax():
    for f in ("ms_quantile", "ms_iterations", "ms_num_samples",
              "ms_max_clusters", "ms_retry_factor", "ms_tol"):
        assert getattr(Config(), f) == getattr(JaxConfig(), f), f
    defaults = inspect.signature(guard_jax).parameters
    want = {k: defaults[k].default
            for k in ("max_clusters", "retry_factor", "tol")}
    want.update(num_samples=5000, quantile=0.015, iterations=50)
    assert cluster_settings(HEADLINE, 10000) == want
    assert cluster_settings(HEADLINE, 512)["num_samples"] == 512


# segment_batch clusters under the Config it is given: ms_max_clusters=3
# caps each shape at 2 clusters where the headline settings find more.
def test_segment_batch_reads_cluster_fields():
    _, x = headline_shapes(1, 512)
    model = load_models(CKPT, device="cpu", which=("inst",))["inst"]
    x = torch.from_numpy(x)
    free, _ = segment_batch(model, x, torch.Generator().manual_seed(0))
    capped, _ = segment_batch(model, x, torch.Generator().manual_seed(0),
                              cfg=Config(ms_max_clusters=3))
    assert int(free.max()) >= 2 and int(capped.max()) <= 1


def test_batch_iou_of_true_labels_is_one():
    shapes, _ = headline_shapes(2, 1200)
    labels = np.stack([s["labels"] for s in shapes])
    types = np.stack([s["prim"] for s in shapes])
    inst, typ, per = batch_iou(shapes, labels, types)
    assert inst == pytest.approx(1.0) and typ == 1.0 and len(per) == 2
