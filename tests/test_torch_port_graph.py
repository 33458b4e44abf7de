"""The port's gather-reduce (kernel K6's plain version,
sednet_tpu_torch.ops.graph) against the JAX package's gather and
reductions on the CPU, the edge convolution that goes through it, and the
Morton row order (`locality_order`) that the encoder hands it."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.ops.flash_topk import _locality_order
from sednet_tpu.ops.graph import gather_neighbors as gather_jax
from sednet_tpu.train import build_model, load_params
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.ops import graph
from sednet_tpu_torch.ops.graph import (edge_conv_factored, gather_reduce,
                                        gather_reduce_plain, locality_order)
from sednet_tpu_torch.predict import headline_shapes, load_models

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "bench_10k.npz")

B, N, K = 2, 300, 16


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, N, c)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K))
    # out-of-range entries clamp within their own shape, never read the
    # other shape's rows
    idx[0, :5, 0] = -3
    idx[1, 7, :4] = N + 11
    idx[1, 8, 3] = 2 * N
    return a, idx


# The same gathered rows in both: the max is exact; the two sums run over
# K = 16 terms in other orders, within 1e-5 relative.
@pytest.mark.parametrize("c", [64, 128])
def test_gather_reduce_plain_matches_jax(c):
    a, idx = _inputs(c, c)
    g = gather_jax(jnp.asarray(a), jnp.asarray(idx.astype(np.int32)))
    want = (np.asarray(g.sum(2)), np.asarray((g * g).sum(2)),
            np.asarray(g.max(2)))
    got = gather_reduce_plain(torch.from_numpy(a), torch.from_numpy(idx))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


# A CPU tensor takes the plain version and launches nothing.
def test_gather_reduce_takes_plain_version_on_cpu():
    a, idx = _inputs(64, 1)
    at, it = torch.from_numpy(a), torch.from_numpy(idx)
    before = gather_reduce.launches
    got = gather_reduce(at, it)
    assert gather_reduce.launches == before
    for g, w in zip(got, gather_reduce_plain(at, it)):
        assert torch.equal(g, w)


# edge_conv_factored through the gather-reduce against the edge convolution
# written out on the gathered (B, N, K, C) edge features: the same function
# to float32 reassociation (GroupNorm statistics over N*K*gsz terms).
def test_edge_conv_factored_matches_explicit_edge_features():
    rng = np.random.default_rng(3)
    c_in, c_out, groups = 8, 64, 2
    x = torch.from_numpy(rng.standard_normal((B, N, c_in)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, N, (B, N, K)))
    w = torch.from_numpy(rng.standard_normal((c_out, 2 * c_in)).astype(
        np.float32) / 4)
    scale = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
    got = edge_conv_factored(x, idx, w, scale, bias, groups=groups)

    xj = x[torch.arange(B)[:, None, None], idx]               # (B, N, K, C)
    xi = x[:, :, None, :].expand_as(xj)
    h = torch.cat([xj - xi, xi], -1) @ w.T                    # (B, N, K, C)
    hg = h.reshape(B, N, K, groups, c_out // groups)
    mean = hg.mean(dim=(1, 2, 4), keepdim=True)
    var = (hg * hg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean
    y = ((hg - mean) * torch.rsqrt(var + 1e-6)).reshape(B, N, K, c_out)
    want = torch.nn.functional.leaky_relu(y * scale + bias, 0.2).amax(2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _jax_orders(xyz):
    return np.stack([np.asarray(_locality_order(jnp.asarray(c)))
                     for c in xyz])


# The port's Morton order against JAX's on the xyz of two 2048-point eval
# clouds, and on a cloud where every point appears two or three times (a
# stable sort keeps duplicated keys in row order in both). The centring
# mean is a float32 sum in another order in the two frameworks, so a point
# on a quantisation edge could change its key: at most 1 row in 1000 may
# differ (on these clouds none did when the test was written).
@pytest.mark.parametrize("cloud", ["eval", "duplicated"])
def test_locality_order_matches_jax(cloud):
    if cloud == "eval":
        xyz = headline_shapes(2, 2048)[1][..., :3]
    else:
        rng = np.random.RandomState(4)
        base = rng.randn(700, 3).astype(np.float32)
        xyz = base[rng.randint(0, 700, (2, 2048))]
        xyz[:, :700] = base   # every base point at least once
    xyz = np.ascontiguousarray(xyz)
    got = locality_order(torch.from_numpy(xyz))
    assert got.dtype == torch.int32 and got.shape == xyz.shape[:2]
    for row in got.numpy():
        assert np.array_equal(np.sort(row), np.arange(xyz.shape[1]))
    differ = int((got.numpy() != _jax_orders(xyz)).sum())
    assert differ <= xyz.shape[0] * xyz.shape[1] // 1000


# Wider rows, once refused, take the JAX function's PCA branch (held to
# JAX's order in tests/test_torch_port_row_order.py) and give a
# permutation; a tensor that is not (B, N, D) raises, and D < 3 is padded
# with zero axes as JAX pads it.
def test_locality_order_takes_xyz_only():
    rng = np.random.RandomState(5)
    with pytest.raises(ValueError, match="must be \\(B, N, D\\)"):
        locality_order(torch.from_numpy(rng.randn(50, 6).astype(np.float32)))
    wide = locality_order(torch.from_numpy(rng.randn(1, 50, 6).astype(
        np.float32)))
    assert torch.equal(torch.sort(wide[0]).values,
                       torch.arange(50, dtype=torch.int32))
    xy = rng.randn(1, 300, 2).astype(np.float32)
    np.testing.assert_array_equal(locality_order(torch.from_numpy(xy)),
                                  _jax_orders(xy))


# On the CPU the order is checked and ignored: the result with a Morton,
# reversed or random order is the result without one, bit for bit, and a
# malformed order raises.
def test_gather_reduce_with_order_equals_without_on_cpu():
    a, idx = _inputs(64, 2)
    at, it = torch.from_numpy(a), torch.from_numpy(idx)
    rng = np.random.RandomState(6)
    xyz = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32))
    want = gather_reduce(at, it)
    for order in (locality_order(xyz),
                  torch.arange(N - 1, -1, -1, dtype=torch.int32).expand(B, N),
                  torch.from_numpy(np.stack([rng.permutation(N)
                                             for _ in range(B)]).astype(
                                                 np.int32))):
        for g, w in zip(gather_reduce(at, it, order), want):
            assert torch.equal(g, w)
    good = locality_order(xyz)
    for bad in (good[:, 1:], good[0], good.long()):
        with pytest.raises(ValueError, match="order"):
            gather_reduce(at, it, bad)


# The encoder computes one Morton order of the points per call and hands it
# to its three edge convolutions; the forward with the order threaded
# through still matches JAX's model at atol 1e-4 (the tolerance of
# tests/test_torch_port_model.py: float association through 3 edge convs
# and 6 GroupNorms).
def test_encoder_threads_one_morton_order(monkeypatch):
    _, x = headline_shapes(1, 512)
    jmodel = build_model(JaxConfig(num_points=512, knn=64, embed=128))
    want = jmodel.apply({"params": load_params(CKPT)["inst"]},
                        jnp.asarray(x))
    model = load_models(CKPT, Config(knn=64, embed=128), device="cpu",
                        which=("inst",))["inst"]
    seen = []
    real = graph.gather_reduce

    def spy(a, idx, order=None):
        seen.append(order)
        return real(a, idx, order)

    monkeypatch.setattr(graph, "gather_reduce", spy)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    order = locality_order(torch.from_numpy(x[..., :3]))
    assert len(seen) == 3 and all(torch.equal(o, order) for o in seen)
    np.testing.assert_allclose(got.embedding.numpy(),
                               np.asarray(want.embedding), atol=1e-4)


def _bwd_case(b, n, c, k, seed, hub=None):
    """K6b's inputs on the CPU from a numpy seed: a table with dense ties
    (values in {-2 .. 2}), a graph with repeated and out-of-range
    neighbours (and, given `hub`, every row listing row `hub` first), K6's
    max on it and three cotangents."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2, 3, (b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k))
    idx[:, ::3, 1] = idx[:, ::3, 0]
    idx[0, :5, 0] = -3
    idx[-1, 7, :3] = n + 11
    if hub is not None:
        idx[:, :, 0] = hub
    a, idx = torch.from_numpy(a), torch.from_numpy(idx)
    cot = [torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
           for _ in range(3)]
    return a, idx, gather_reduce_plain(a, idx)[2], cot


def _np_terms(a, idx, mx, gs, gsq, gmx):
    """The terms of K6b's sums in numpy float32, each rounded as the plain
    version rounds it: (gs + (2 a[j]) gsq) + (tie ? gmx / cnt : 0), per
    edge e = (b N + i) K + k: (B N K, C), and the flat destinations."""
    a, mx, gs, gsq, gmx = (t.numpy() for t in (a, mx, gs, gsq, gmx))
    b, n, c = a.shape
    j = np.clip(idx.numpy(), 0, n - 1)
    g = a[np.arange(b)[:, None, None], j]
    tie = g == mx[:, :, None, :]
    cnt = tie.sum(2).astype(np.float32)
    w = np.where(cnt > 0, gmx / np.maximum(cnt, np.float32(1)), np.float32(0))
    t = gs[:, :, None, :] + (np.float32(2) * g) * gsq[:, :, None, :]
    t = t + np.where(tie, w[:, :, None, :], np.float32(0))
    dest = (j + n * np.arange(b)[:, None, None]).reshape(-1)
    return t.reshape(-1, c).astype(np.float32), dest


# K6b's transpose: every edge e = (b N + i) K + k exactly once, at its
# clamped destination b N + j, in ascending e within a destination, and
# the ends the cumsum of the in-degree; out-of-range and repeated
# neighbours, B = 1 and 3.
@pytest.mark.parametrize("b", [1, 3])
def test_graph_transpose_matches_numpy(b):
    n, k = 257, 6
    _, idx, _, _ = _bwd_case(b, n, 8, k, b)
    ends, eids = graph.graph_transpose(idx, n)
    assert ends.dtype == eids.dtype == torch.int32
    e = eids.numpy().astype(np.int64)
    np.testing.assert_array_equal(np.sort(e), np.arange(b * n * k))
    dest = (np.clip(idx.numpy(), 0, n - 1)
            + n * np.arange(b)[:, None, None]).reshape(-1)
    ds = dest[e]
    assert np.all(np.diff(ds) >= 0)
    assert np.all(np.diff(e)[np.diff(ds) == 0] > 0)
    np.testing.assert_array_equal(
        ends.numpy(), np.cumsum(np.bincount(dest, minlength=b * n)))
    starts = np.concatenate([[0], ends.numpy()[:-1]])
    for d in (0, 5, b * n - 1):
        assert np.all(ds[starts[d]:ends[d]] == d)


# The property K6b's bit equality rests on: the plain version (the CPU's
# index_add_) is, bit for bit, the sequential sum from +0 of each
# destination's terms in ascending e, walked over graph_transpose's lists;
# also with a hub, a row listed first by every row (in-degree above N).
@pytest.mark.parametrize("c,k,hub", [(32, 4, None), (64, 16, None),
                                     (32, 8, 5), (64, 4, 0)])
def test_gather_reduce_backward_plain_is_sequential_sum(c, k, hub):
    b, n = 2, 300
    a, idx, mx, cot = _bwd_case(b, n, c, k, c + k, hub=hub)
    terms, _ = _np_terms(a, idx, mx, *cot)
    ends, eids = (t.numpy() for t in graph.graph_transpose(idx, n))
    want = np.zeros((b * n, c), np.float32)
    start = 0
    for d in range(b * n):
        acc = np.zeros(c, np.float32)
        for e in eids[start:ends[d]]:
            acc = acc + terms[e]
        want[d] = acc
        start = ends[d]
    got = graph.gather_reduce_backward_plain(a, idx, mx, *cot)
    assert torch.equal(got, torch.from_numpy(want).reshape(b, n, c))


def _emulate_k6b(a, idx, mx, gs, gsq, gmx, order):
    """numpy emulation of csrc/gather_reduce_bwd.cu's passes at the padded
    width, in the kernel's order of adds: pass 1 along `order` writes the
    tie mask (word u of edge e holds, at bit l, the tie of channel l CJ +
    u, CJ = C / 32) and w; pass 2 walks each destination's list whole
    along `order`, reading ties back from the mask."""
    b, n, c = a.shape
    cp = -(-c // 32) * 32
    cj = cp // 32
    a, mx, gs, gsq, gmx = (np.pad(t.numpy(), ((0, 0), (0, 0), (0, cp - c)))
                           .reshape(b * n, cp)
                           for t in (a, mx, gs, gsq, gmx))
    k = idx.shape[2]
    j = np.clip(idx.numpy(), 0, n - 1) + n * np.arange(b)[:, None, None]
    j = j.reshape(b * n, k)
    ends, eids = (t.numpy().astype(np.int64)
                  for t in graph.graph_transpose(idx, n))
    rows = (order.numpy() + n * np.arange(b)[:, None]).reshape(-1)
    mask = np.zeros(b * n * k * cj, np.uint32)
    w = np.zeros((b * n, cp), np.float32)
    shifts = np.arange(32, dtype=np.uint32)
    for r in rows:
        tie = a[j[r]] == mx[r]
        cnt = tie.sum(0).astype(np.float32)
        w[r] = np.where(cnt > 0, gmx[r] / np.maximum(cnt, np.float32(1)), 0)
        words = (tie.reshape(k, 32, cj).astype(np.uint32)
                 << shifts[None, :, None]).sum(1, dtype=np.uint32)
        mask[r * k * cj:(r + 1) * k * cj] = words.reshape(-1)

    def walk(d, e0, e1):
        acc = np.zeros(cp, np.float32)
        a2 = np.float32(2) * a[d]
        for e in eids[e0:e1]:
            i = e // k
            bits = mask[e * cj:(e + 1) * cj]
            tie = ((bits[None, :] >> shifts[:, None]) & 1).reshape(-1) == 1
            t = gs[i] + a2 * gsq[i]
            acc = acc + (t + np.where(tie, w[i], np.float32(0)))
        return acc

    starts = np.concatenate([[0], ends[:-1]])
    da = np.zeros((b * n, cp), np.float32)
    for d in rows:
        da[d] = walk(d, starts[d], ends[d])
    return torch.from_numpy(da[:, :c].reshape(b, n, c))


# The kernel's index arithmetic (the mask's bit layout, the walk along a
# row order, the padded width C = 40 at 64, a hub walked whole) emulated
# in numpy gives the plain version's bits.
@pytest.mark.parametrize("ordered", [False, True])
def test_gather_reduce_backward_kernel_emulation(ordered):
    b, n, c, k = 2, 200, 40, 6
    a, idx, mx, cot = _bwd_case(b, n, c, k, 7, hub=3)
    order = torch.arange(n, dtype=torch.int32).expand(b, n)
    if ordered:
        order = torch.from_numpy(np.stack([
            np.random.default_rng(s).permutation(n) for s in range(b)
        ]).astype(np.int32))
    got = _emulate_k6b(a, idx, mx, *cot, order)
    assert torch.equal(got, graph.gather_reduce_backward_plain(a, idx, mx,
                                                               *cot))
