"""The port's matrix-free spectral path (sednet_tpu_torch.cluster.spectral:
the sparse affinity, the sorted layout, the five A^T v layouts of the
LOBPCG matvec, kernel K5's plain version, `hpnet_enrich`, and
`predict_shapes` above `spectral_dense_max_n`) against the JAX package on
the CPU. Random inputs (LOBPCG start blocks, bandwidth subsamples) are
JAX's, handed to the port."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.cluster import spectral as spectral_jax
from sednet_tpu.ops.pallas_kernels import segsum_sorted_scan_pallas
from sednet_tpu_torch.cluster import guard_mean_shift
from sednet_tpu_torch.cluster import spectral
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.data import make_synthetic_shape
from sednet_tpu_torch.ops.cuda_kernels import (segsum_sorted_scan,
                                               segsum_sorted_scan_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: torch's intra-op threads cost more than they
    save here, and in a parallel test run they compete with the other
    workers' (a 0.14 s solve took 3 s that way). One thread also fixes the
    summation order that `test_predict_shapes_matfree_matches_jax`'s
    tolerances were measured at."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(n, 3).astype(np.float32)
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, nrm


def _sparse_jax(xyz, nrm, k):
    return (np.array(a) for a in spectral_jax.normal_affinity_sparse(
        jnp.asarray(xyz), jnp.asarray(nrm), k=k))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_sels(key, n, m, attempts=17):
    """The bandwidth subsamples JAX's guard_mean_shift draws from `key`,
    one per attempt."""
    sels = []
    for _ in range(attempts):
        key, sub = jax.random.split(key)
        sels.append(torch.from_numpy(
            np.array(jax.random.permutation(sub, n)[:m])))
    return sels


# The same k farthest neighbours in the same order (K1's plain version and
# JAX's top_k break ties alike); w and rsqrt_deg go through arccos and exp,
# which the two libraries approximate differently by an ulp, and one ulp of
# the angle moves w by up to theta / sigma^2 = 300 ulps near the -0.99
# clamp: held at rtol 1e-4 (measured 1.9e-5 for w, 3.0e-6 for rsq), atol
# 1e-30 for weights in the denormal range.
def test_normal_affinity_sparse_matches_jax():
    xyz, nrm = _cloud(0, 200)
    idx_j, w_j, rsq_j = _sparse_jax(xyz, nrm, 12)
    idx, w, rsq = spectral.normal_affinity_sparse(*_t(xyz, nrm), k=12)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_allclose(w.numpy(), w_j, rtol=1e-4, atol=1e-30)
    np.testing.assert_allclose(rsq.numpy(), rsq_j, rtol=1e-4)
    assert rsq_j.max() / rsq_j.min() > 1e5  # the quirk's range, no fill
    _, w2, _ = spectral.normal_affinity_sparse(
        *_t(xyz, nrm), k=12, idx=torch.from_numpy(idx_j).long())
    assert torch.equal(w2, w)


def test_sorted_transpose_layout_matches_jax():
    xyz, nrm = _cloud(1, 200)
    idx, w, rsq = _sparse_jax(xyz, nrm, 12)
    coef = w * rsq[idx] * rsq[:, None]
    want = spectral_jax._sorted_transpose_layout(jnp.asarray(idx),
                                                 jnp.asarray(coef))
    got = spectral._sorted_transpose_layout(torch.from_numpy(idx).long(),
                                            torch.from_numpy(coef))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


# Each layout's matvec against JAX's matvec re-derived in numpy from JAX's
# affinity (tests/test_cluster.py:158-165), at JAX's own bounds rtol 2e-4,
# atol 1e-5: the coefficients span ~1e12 and every layout sums in its own
# order. "vocab-overflow" caps the vocabulary below the graph's distinct
# targets, so the per-edge fallback runs.
@pytest.mark.parametrize("mode", ["scatter", "sorted", "scan", "pallas",
                                  "vocab", "vocab-overflow"])
def test_matvec_modes_match_jax(mode):
    n, k, m = 70, 9, 5
    xyz, nrm = _cloud(2, n)
    idx, w, rsq = _sparse_jax(xyz, nrm, k)
    coef = w * rsq[idx] * rsq[:, None]
    v = np.random.RandomState(3).randn(n, m).astype(np.float32)
    atv = np.zeros((n, m), np.float32)
    np.add.at(atv, idx.reshape(-1), (coef[..., None] * v[:, None, :]
                                     ).reshape(-1, m))
    want = 0.5 * ((v[idx] * coef[..., None]).sum(1) + atv)
    cap = {"vocab-overflow": 8}.get(mode)
    matvec = spectral.matfree_matvec(
        *_t(xyz, nrm), knn=k, idx=torch.from_numpy(idx).long(),
        transpose_mode=mode.split("-")[0], vocab_cap=cap)
    np.testing.assert_allclose(matvec(torch.from_numpy(v)).numpy(), want,
                               rtol=2e-4, atol=1e-5)


def test_transpose_mode_names():
    for vmapped in (False, True):
        assert (spectral.default_transpose_mode(vmapped)
                == spectral_jax.default_transpose_mode(vmapped))
        assert spectral.default_transpose_mode(vmapped) in \
            spectral.TRANSPOSE_MODES
    for n in (256, 10000, 32768, 100000):
        assert (spectral._default_vocab_cap(n)
                == spectral_jax._default_vocab_cap(n))
    with pytest.raises(ValueError, match="transpose_mode"):
        spectral.matfree_matvec(*_t(*_cloud(0, 40)), knn=4,
                                transpose_mode="cumsum")


# The skewed fixture of tests/test_pallas.py:200-219: destinations soaking
# up 700 and 450 entries, many empty, values over six decades. The plain
# version is JAX's segmented scan, the same adds in the same order as JAX's
# `_segment_sum_sorted_scan` (bit-equal); against the Pallas kernel, whose
# tiles carry across boundaries in another order, within rtol 2e-4 / atol
# 1e-5 as JAX holds it. Empty destinations are exactly 0.
def test_segsum_sorted_scan_plain_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    n, m = 97, 7
    parts = [rng.randint(0, n, size=300), np.full(700, 3), np.full(450, 91),
             np.full(5, 0)]
    dest = np.sort(np.concatenate(parts)).astype(np.int32)
    e = dest.shape[0]
    vals = (rng.randn(e, m) * 10.0 ** rng.uniform(-3, 3, (e, 1))).astype(
        np.float32)
    counts = np.bincount(dest, minlength=n)
    ends = np.cumsum(counts).astype(np.int32)
    want = np.asarray(segsum_sorted_scan_pallas(
        jnp.asarray(vals.T), jnp.asarray(dest), jnp.asarray(ends),
        interpret=True))
    vt, dt, et = _t(vals.T, dest, ends)
    before = segsum_sorted_scan.launches
    got = segsum_sorted_scan(vt, dt, et).numpy()
    assert segsum_sorted_scan.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got, segsum_sorted_scan_plain(vt, dt, et))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert np.all(got[counts == 0] == 0.0) and (counts == 0).any()
    scan = spectral._segment_sum_sorted_scan(torch.from_numpy(vals), dt, n,
                                             et)
    np.testing.assert_array_equal(scan.numpy(), np.asarray(
        spectral_jax._segment_sum_sorted_scan(
            jnp.asarray(vals), jnp.asarray(dest), n, jnp.asarray(ends))))
    np.testing.assert_array_equal(scan.numpy(), got)


def _block_piece_sum(vals_t, c0, p0, p1, chunk):
    """The sum of the entries [p0, p1) of vals_t (m, E), a piece of the
    chunk that starts at c0, in the order of one block of K5
    (csrc/segsum.cu segsum_pieces): warp w of the 8 owns the span
    [c0 + w chunk / 8, c0 + (w + 1) chunk / 8) of the chunk, lane l of a
    warp the entries whose offset from c0 is 4 l + t (t < 4) modulo 128;
    each lane adds its entries in the piece in ascending order, a butterfly
    of shuffles (xor 16, 8, 4, 2, 1) adds a warp's lanes, and the warps'
    sums are added in warp order."""
    span = chunk // 8
    total = None
    for w in range(8):
        a, b = max(p0, c0 + span * w), min(p1, c0 + span * (w + 1))
        if a >= b:
            continue
        lanes = np.zeros((vals_t.shape[0], 32), np.float32)
        for e in range(a, b):
            lane = (e - c0) // 4 % 32
            lanes[:, lane] = lanes[:, lane] + vals_t[:, e]
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        total = lanes[:, 0] if total is None else total + lanes[:, 0]
    return total


def _k5_chunk_plan(vals_t, ends, chunk):
    """numpy emulation of K5's two launches on (m, E) entries. Pass 1:
    chunk c of the entries is one block, which finds by position the pieces
    of the segments that touch it and sums each (`_block_piece_sum`); a
    segment wholly inside goes to out, the piece of the segment that ran
    into the chunk to first[c], the piece of the one that runs on past it to
    last[c]. Pass 2 writes 0 for every empty destination and adds a
    crossing segment's pieces in chunk order. Returns (out (N, m), the
    number of writes of each out row)."""
    m, e = vals_t.shape
    n = ends.shape[0]
    ends = ends.astype(np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    chunks = max(1, -(-e // chunk))
    out = np.full((n, m), np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    first = np.full((chunks, m), np.nan, np.float32)
    last = np.full((chunks, m), np.nan, np.float32)
    cross = np.full(chunks, -1)
    for c in range(chunks):
        c0, c1 = c * chunk, min((c + 1) * chunk, e)
        p = c0
        while p < c1:
            d = int(np.searchsorted(ends, p, side="right"))  # holds entry p
            if d >= n:
                break
            s, t = starts[d], ends[d]
            piece = _block_piece_sum(vals_t, c0, max(s, c0), min(t, c1),
                                     chunk)
            if s < c0:
                first[c] = piece
            elif t > c1:
                last[c] = piece
                cross[c] = d
            else:
                out[d] = piece
                writes[d] += 1
            p = t
    empty = ends <= starts
    out[empty] = 0.0
    writes[empty] += 1
    for c in np.nonzero(cross >= 0)[0]:
        d, acc, c2 = cross[c], last[c], c + 1
        while c2 < chunks and c2 * chunk < ends[d]:
            acc = acc + first[c2]
            c2 += 1
        out[d] = acc
        writes[d] += 1
    return out, writes


PLAN_CHUNK = 2048   # the kernel's: 8 warps of 256 entries


def _plan_counts(kind, rng, chunk=PLAN_CHUNK):
    """Destination counts of the layouts that stress the chunk plan."""
    if kind == "one_destination":
        counts = np.zeros(50, np.int64)
        counts[25] = 5 * chunk + 17
    elif kind == "every_one":
        counts = np.ones(3 * chunk + 5, np.int64)
    elif kind == "chunk_edges":
        counts = np.array([0, chunk, 0, chunk // 2, chunk // 2, 3 * chunk, 0,
                           chunk - 1, 1, 0], np.int64)
    elif kind == "empty_ends":
        counts = np.zeros(120, np.int64)
        counts[5:-5] = rng.randint(0, 9, 110)
        counts[17] = 3 * chunk + 11
    else:   # ragged: skewed, E not a multiple of the chunk
        counts = np.zeros(300, np.int64)
        hot = rng.choice(300, 12, replace=False)
        counts[hot] = rng.randint(1, 3 * chunk, 12)
        counts[hot[0]] = 4 * chunk - 3
    return counts


# K5's chunk plan, emulated in numpy with the kernel's order of adds, on
# the layouts that stress it: one destination holding every entry, every
# destination one entry, segments ending exactly on chunk edges, empty
# destinations first and last, E not a multiple of the chunk; m = 1 and 37.
# Every destination is written exactly once. On small integers, whose every
# partial sum is exact in float32, it equals the plain version bit for bit;
# on entries over six decades it is within 1e-5 of each segment's sum of
# |entries| (K5's tolerance on the card: another order of pairwise adds) of
# the plain version and of the Pallas kernel in interpret mode. A tolerance
# relative to the sum itself does not bound a reordering where the entries
# cancel (a long segment of entries up to 1e3 can sum to below 1); empty
# destinations are exactly 0.
@pytest.mark.parametrize("m", [1, 37])
@pytest.mark.parametrize("kind", ["one_destination", "every_one",
                                  "chunk_edges", "empty_ends", "ragged"])
def test_segsum_chunk_plan_emulation(kind, m):
    rng = np.random.RandomState(len(kind) * 7 + m)
    counts = _plan_counts(kind, rng)
    dest = np.repeat(np.arange(counts.shape[0]), counts).astype(np.int32)
    ends = np.cumsum(counts).astype(np.int32)
    e = dest.shape[0]
    ints = rng.randint(-8, 9, (m, e)).astype(np.float32)
    got, writes = _k5_chunk_plan(ints, ends, PLAN_CHUNK)
    assert np.all(writes == 1)
    np.testing.assert_array_equal(
        got, segsum_sorted_scan_plain(*_t(ints, dest, ends)).numpy())

    vals = (rng.randn(m, e) * 10.0 ** rng.uniform(-3, 3, (1, e))).astype(
        np.float32)
    got, _ = _k5_chunk_plan(vals, ends, PLAN_CHUNK)
    vt, dt, et = _t(vals, dest, ends)
    plain = segsum_sorted_scan_plain(vt, dt, et).numpy()
    scale = segsum_sorted_scan_plain(vt.abs(), dt, et).numpy()
    assert np.all(np.abs(got - plain) <= 1e-5 * scale)
    want = np.asarray(segsum_sorted_scan_pallas(
        jnp.asarray(vals), jnp.asarray(dest), jnp.asarray(ends),
        interpret=True))
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    assert np.all(got[counts == 0] == 0.0)


# The downstream invariant of tests/test_cluster.py:236-260: the farthest
# quirk's eigenvectors are localised, so eigenvectors are not compared
# across layouts; the enriched embedding's mean-shift partition is. From
# JAX's start block and JAX's subsamples, every layout gives the same
# labels, with as many clusters as ground-truth segments.
def test_hpnet_enrich_modes_give_the_same_labels():
    d = make_synthetic_shape(np.random.RandomState(5), n_points=256,
                             n_segments=4)
    lab = d["labels"].astype(np.int64)
    oh = np.zeros((256, 8), np.float32)
    oh[np.arange(256), lab] = 1.0
    oh += 0.05 * np.random.RandomState(1).randn(*oh.shape)
    oh /= np.linalg.norm(oh, axis=1, keepdims=True)
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(2), (256, 4),
                                    jnp.float32))
    sels = _jax_sels(jax.random.PRNGKey(3), 256, 256)
    emb, xyz, nrm = _t(oh.astype(np.float32), d["points"].astype(np.float32),
                       d["normals"].astype(np.float32))
    outs = {}
    for mode in spectral.TRANSPOSE_MODES:
        e = spectral.hpnet_enrich(emb, xyz, nrm, x0=x0, knn=12, eig_k=4,
                                  transpose_mode=mode)
        np.testing.assert_allclose(torch.linalg.vector_norm(e, dim=1), 1.0,
                                   atol=1e-5)
        res = guard_mean_shift(e, num_samples=256, quantile=0.015,
                               iterations=30, sel=sels)
        outs[mode] = (res.labels.numpy(), int(res.num_clusters))
    k_gt = int(np.unique(lab).shape[0])
    for mode, (labels, num) in outs.items():
        assert num == k_gt, (mode, num, k_gt)
        np.testing.assert_array_equal(labels, outs["scatter"][0])


# N = 256 above spectral_dense_max_n = 128: the matrix-free solver with the
# default "scatter" layout, and no dense affinity at all.
def test_spectral_embed_takes_matfree_branch(monkeypatch):
    from sednet_tpu_torch import predict

    xyz, nrm = _t(*_cloud(4, 256))
    x0 = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (256, 12), jnp.float32)))

    def no_dense(*args, **kw):
        raise AssertionError("dense affinity built above the cap")

    monkeypatch.setattr(predict, "normal_affinity_topk", no_dense)
    v, ent = predict.spectral_embed(xyz, nrm, Config(spectral_dense_max_n=128),
                                    x0=x0)
    want = spectral.spectral_eigvecs_matfree(xyz, nrm, x0)
    assert torch.equal(v, want)
    assert torch.equal(ent, spectral.compute_entropy(want))


def ari(a, b):
    """Adjusted Rand index of two labelings."""
    a = np.unique(np.asarray(a), return_inverse=True)[1]
    b = np.unique(np.asarray(b), return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(table, (a, b), 1)
    pairs = lambda v: (v * (v - 1) / 2).sum()  # noqa: E731
    sa, sb = pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / pairs(np.array([len(a)]))
    top = 0.5 * (sa + sb) - expected
    return 1.0 if top == 0 else (pairs(table) - expected) / top


# The reference-default eval through the matrix-free branch (N = 384 above
# spectral_dense_max_n = 256), both models on the trained weights, with
# JAX's start blocks and subsamples (ms_tol = 0: both run 50 steps). The
# two solves agree per raw eigenvector column within 1e-3, but 10 LOBPCG
# steps do not converge and the row normalisation divides rows of norm
# ~1e-6 (as on the dense path, test_torch_port_predict.py), and the
# affinity's weights differ by arccos/exp ulps. Measured (port vs JAX) at
# the module's one torch thread: shape 0 identical (5 clusters, inst_iou
# 0.77774, type_iou 0.8); shape 1, 10 clusters in both, ARI 0.996, inst_iou
# 0.81169 vs 0.80913, type_iou 0.8333 in both; recall equal. (With eight
# threads shape 1's summation order alone moves it to ARI 0.954 and one
# segment's type match: the reason the module pins one thread.) So counts,
# recall and type_iou are held exact, the partition at ARI 0.97, inst_iou
# at 0.01 (measured gap 0.0026).
def test_predict_shapes_matfree_matches_jax():
    from sednet_tpu.config import Config as JaxConfig
    from sednet_tpu.predict import predict_shapes as predict_jax
    from sednet_tpu.train import build_model, load_params
    from sednet_tpu_torch.predict import (headline_shapes, load_models,
                                          predict_shapes)

    n = 384
    kw = dict(num_points=n, knn=16, embed=128, hpnet_embed=True,
              ms_num_samples=5000, ms_tol=0.0, spectral_dense_max_n=256)
    sh, _ = headline_shapes(2, n)
    batch = {k: np.stack([s[k] for s in sh])
             for k in ("points", "normals", "labels", "prim")}
    ckpt = os.path.join(ROOT, "checkpoints", "bench_10k.npz")
    jcfg = JaxConfig(**kw)
    key = jax.random.PRNGKey(7)
    want = predict_jax(build_model(jcfg), *(load_params(ckpt)[m]
                                            for m in ("type", "inst")),
                       batch, jcfg, key=key)
    x0s = [np.array(jax.random.normal(jax.random.fold_in(key, i), (n, 12),
                                      jnp.float32)) for i in range(2)]
    sels = [_jax_sels(jax.random.fold_in(key, 1000 + i), n, n)
            for i in range(2)]
    cfg = Config(**kw)
    models = load_models(ckpt, cfg, device="cpu")
    got = predict_shapes(models["type"], models["inst"], batch, cfg,
                         x0s=x0s, sels=sels)
    for g, w in zip(got, want):
        assert ari(g["cluster_ids"], w["cluster_ids"]) >= 0.97
        assert g["num_clusters"] == w["num_clusters"]
        assert g["inst_recall"] == pytest.approx(w["inst_recall"], abs=1e-12)
        assert g["inst_iou"] == pytest.approx(w["inst_iou"], abs=0.01)
        assert g["type_iou"] == pytest.approx(w["type_iou"], abs=1e-12)
