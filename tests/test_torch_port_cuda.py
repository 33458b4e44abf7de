"""The CUDA kernels of sednet_tpu_torch against their plain PyTorch
versions, on the card. Without an NVIDIA GPU every test here skips: a CUDA
kernel has no CPU mode. This file imports no JAX, so that it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch

from sednet_tpu_torch.ops import cuda_kernels as ck
from sednet_tpu_torch.ops import fused_edgeconv as fe
from sednet_tpu_torch.cluster import cluster_batch, guard_mean_shift
from sednet_tpu_torch.cluster.spectral import hpnet_enrich
from sednet_tpu_torch.data import make_synthetic_shape
from sednet_tpu_torch.ops.graph import (backward_error_bound, gather_reduce,
                                        gather_reduce_backward,
                                        gather_reduce_backward_plain,
                                        gather_reduce_plain, graph_transpose,
                                        locality_order)
from sednet_tpu_torch.ops.flash_topk import (compare_with_plain, flash_topk,
                                             topk_plain)


def _points_normals(rng, n):
    x = rng.randn(n, 6).astype(np.float32)
    x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    return x


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _tie_heavy(rng, r, c, e=16, vocab=7):
    voc = _unit(rng, vocab, e)
    return voc[rng.randint(0, vocab, r)], voc[rng.randint(0, vocab, c)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _topk_holds(q, p, k, metric="sqdist", largest=False):
    """Launch K1 once and hold it to compare_with_plain (tolerances and the
    near-tie rule there); returns (idx, dist)."""
    before = flash_topk.launches
    idx, dist = flash_topk(q, p, k, metric=metric, largest=largest,
                           return_distances=True)
    torch.cuda.synchronize()
    assert flash_topk.launches == before + 1
    assert idx.shape == (*q.shape[:-1], k) and idx.dtype == torch.int64
    cmp = compare_with_plain(q, p, k, idx, dist, metric=metric,
                             largest=largest)
    assert cmp["bad_rows"] == 0 and cmp["max_abs_err"] <= cmp["tol"], cmp
    assert cmp["nbr_err"] <= cmp["tol"], cmp
    assert cmp["swapped_rows"] <= 0.01 * cmp["rows"], cmp
    return idx, dist


# d <= 8 and points_normals take the CUDA-core tile, d > 8 the tensor-core
# one (three-term TF32 split, rows zero-padded to a multiple of 16); k
# picks the list length (32, 64 or 128).
@pytest.mark.cuda
@pytest.mark.parametrize("metric,d,k,largest", [
    ("sqdist", 64, 64, False), ("points_normals", 6, 64, False),
    ("sqdist", 128, 128, False), ("sqdist", 16, 16, True),
    ("sqdist", 3, 50, True), ("sqdist", 160, 128, True),
    ("sqdist", 256, 1, False), ("points_normals", 6, 50, True),
    ("sqdist", 6, 128, False), ("sqdist", 20, 64, True)])
def test_flash_topk_kernel_matches_plain(cuda, metric, d, k, largest):
    rng = np.random.RandomState(1)
    x = np.stack([_points_normals(rng, 2000) for _ in range(2)]) \
        if metric == "points_normals" else \
        (rng.randn(2, 2000, d) / np.sqrt(d)).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    _topk_holds(t, t, k, metric, largest)


# Ragged shapes: rows that leave a block part-full (m = 1, 31, 33, 4097),
# columns that end inside a 32-column tile, a shared 2-d p under batched
# q, and one shape of 5000 rows: at k = 128 and d = 160 in blocks of 48
# rows (as 4097 rows there), at d = 3 with the column split over a
# cluster.
@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,d,k,largest,shared", [
    (1, 1, 37, 3, 1, False, False), (2, 31, 1001, 16, 50, True, False),
    (1, 33, 4099, 64, 64, False, False), (1, 4097, 4097, 160, 128, False,
                                          False),
    (3, 31, 777, 256, 128, True, True), (2, 33, 301, 6, 64, False, True),
    (1, 4097, 1001, 3, 50, True, False), (None, 5000, 5000, 160, 128,
                                          False, False),
    (None, 5000, 5000, 3, 50, True, False)])
def test_flash_topk_kernel_ragged(cuda, b, m, n, d, k, largest, shared):
    rng = np.random.RandomState(3)
    lead = () if b is None else (b,)
    q = (rng.randn(*lead, m, d) / np.sqrt(d)).astype(np.float32)
    p = q if m == n and not shared else (rng.randn(
        *(() if shared else lead), n, d) / np.sqrt(d)).astype(np.float32)
    _topk_holds(torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda),
                k, largest=largest)


# The spectral affinity's 50 farthest on xyz, where CAD clouds hold exact
# ties: on integer coordinates every distance is exact, so the farthest
# sets must be the plain version's, ties broken by the lower index alike.
@pytest.mark.cuda
def test_flash_topk_kernel_farthest_on_exact_ties(cuda):
    rng = np.random.RandomState(7)
    xyz = torch.from_numpy(rng.randint(-4, 5, (3000, 3)).astype(
        np.float32)).to(cuda)
    idx, dist = flash_topk(xyz, xyz, 50, largest=True, return_distances=True)
    pdist, pidx = topk_plain(xyz, xyz, 50, largest=True)
    assert torch.equal(dist, pdist)
    assert torch.equal(idx.sort(-1).values, pidx.sort(-1).values)


# Exact ties, nearest and farthest, on both tiles: small integer
# coordinates make every distance exact (in the TF32 split too: each hi
# part is the integer, each lo part 0), so the kernel must return the
# plain version's indices in the plain version's order, equal distances
# by the lower index.
@pytest.mark.cuda
@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("d,k", [(3, 50), (16, 64), (64, 128)])
def test_flash_topk_kernel_exact_ties_take_lower_index(cuda, d, k, largest):
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randint(-2, 3, (2, 3001, d)).astype(
        np.float32)).to(cuda)
    idx, dist = flash_topk(x, x, k, largest=largest, return_distances=True)
    pdist, pidx = topk_plain(x, x, k, largest=largest)
    assert torch.equal(dist, pdist)
    assert torch.equal(idx, pidx)


# The split keeps float32 accuracy: against the same distances in float64,
# the kernel's returned distances err at most twice as much as the float32
# plain version's (cuBLAS in true float32).
@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(64, 64), (160, 128)])
def test_flash_topk_kernel_keeps_float32_accuracy(cuda, d, k):
    from sednet_tpu_torch.ops.flash_topk import _dist_at

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3000, d).astype(np.float32)).to(cuda)
    idx, dist = flash_topk(x, x, k, return_distances=True)
    pdist, pidx = topk_plain(x, x, k)
    x64 = x.double()
    err = float((dist.double() - _dist_at(x64, x64, idx, "sqdist", 1.0))
                .abs().max())
    plain = float((pdist.double() - _dist_at(x64, x64, pidx, "sqdist", 1.0))
                  .abs().max())
    assert err <= 2.0 * plain, (err, plain)


@pytest.mark.cuda
def test_mean_shift_kernel_matches_plain(cuda):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(_unit(rng, 2, 3000, 128)).to(cuda)
    bw = torch.tensor([0.15, 0.3], device=cuda)
    got = ck.mean_shift_step_batched(x, x, bw)
    want = ck.mean_shift_step_plain(x, x, 1.0 / (bw * bw))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    one = ck.mean_shift_step(x[0], x[0], bw[0])
    torch.testing.assert_close(one, want[0], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_colmax_kernel_matches_plain_on_ties(cuda):
    rng = np.random.RandomState(3)
    rows, cols = _tie_heavy(rng, 3000, 3000, e=128, vocab=40)
    r, c = torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)
    bias = torch.from_numpy(rng.randint(0, 5, 3000).astype(np.float32)).to(cuda)
    for thresh, gain in ((float("inf"), 1.0), (0.5, 0.0)):
        bk, ik = ck.colmax(r, c, bias, thresh, gain)
        bp, ip = ck.colmax_plain(r, c, bias, thresh, gain)
        torch.testing.assert_close(bk, bp, atol=1e-5, rtol=0)
        assert torch.equal(ik, ip)


def _clustered(rng, b, n, e, spread=0.1):
    """(b, n, e) unit rows around 8 centres a shape, neighbours about
    `spread` apart, so that every bandwidth from 0.05 up weighs many
    columns and not only a row's own."""
    centres = _unit(rng, b, 8, e)
    lab = rng.randint(0, 8, (b, n))
    x = np.take_along_axis(centres, lab[..., None], 1)
    x = x + (spread / np.sqrt(e)) * rng.randn(b, n, e)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _ms_kernel(x, bw):
    """K2 for one shape, K2b for a batch, as the main path calls them."""
    if x.shape[0] == 1:
        before = ck.mean_shift_step.launches
        out = ck.mean_shift_step(x[0], x[0], bw[0])[None]
        assert ck.mean_shift_step.launches == before + 1
        return out
    before = ck.mean_shift_step_batched.launches
    out = ck.mean_shift_step_batched(x, x, bw)
    assert ck.mean_shift_step_batched.launches == before + 1
    return out


# The tensor-core step (three-term TF32 split) at ragged N (one row, less
# than one 64-row tile, not a multiple of the 32-column tile), at widths
# that run as they are (32, 256) and padded (140 at 160), for one shape
# (K2) and a batch (K2b), at the bandwidths of the path's range: 1e-5 abs.
@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("e", [32, 140, 256])
@pytest.mark.parametrize("n", [1, 63, 3001])
def test_mean_shift_kernel_ragged_widths_and_bandwidths(cuda, n, e, b):
    rng = np.random.RandomState(11)
    x = torch.from_numpy(_clustered(rng, b, n, e)).to(cuda)
    for bw in (0.05, 0.15, 0.3):
        bws = torch.full((b,), bw, device=cuda)
        got = _ms_kernel(x, bws)
        want = ck.mean_shift_step_plain(x, x, 1.0 / (bws * bws))
        assert got.shape == x.shape
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# The split keeps float32 accuracy: against the same step in float64, the
# kernel errs no more than twice as much as the float32 plain version
# (cuBLAS in true f32) on the same inputs.
@pytest.mark.cuda
@pytest.mark.parametrize("bw", [0.05, 0.15, 0.3])
def test_mean_shift_kernel_keeps_float32_accuracy(cuda, bw):
    rng = np.random.RandomState(12)
    x = torch.from_numpy(_clustered(rng, 2, 3001, 140)).to(cuda)
    bws = torch.full((2,), bw, device=cuda)
    inv_b2 = 1.0 / (bws * bws)
    exact = ck.mean_shift_step_plain(x.double(), x.double(), inv_b2.double())
    got = ck.mean_shift_step_batched(x, x, bws)
    plain = ck.mean_shift_step_plain(x, x, inv_b2)
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_kernel <= 2.0 * err_plain, (err_kernel, err_plain)


def _bf16_rounding_slack(name, got, plain, x, inv_b2):
    """The float64 rule of the bf16 step (`ops.bf16_rule.check_bf16_step`,
    the one the smoke applies): each row within twice the float32 plain
    version's largest error (at least 1e-6, a unit row's rounding), but
    for the weights within float32's error of a bf16 rounding midpoint,
    each of which may round to either of its two bf16 neighbours. Returns
    its record; raises where a row fails."""
    from sednet_tpu_torch.ops.bf16_rule import check_bf16_step

    return check_bf16_step(name, got, plain, x, inv_b2, floor=1e-6)


# The bf16 branch (`ms_bf16`, csrc/mean_shift_bf16.cu) for one shape (K2)
# and a batch (K2b) at widths 12 to 256 (12, 40, 140 and 200 zero-padded to
# 16, 48, 144 and 208: every product shape of P.X, its columns in one
# product of 64, 128, 192 or 256 and a second of 16, 32 or 48) on the
# loop's bf16 columns (`step_columns`), and row counts that fill no whole 128-row block or column tile,
# against the same function in float64 on the bf16-rounded inputs
# (`mean_shift_step_plain(..., bf16=True)` on float64). Each element errs
# at most twice as much as the float32 plain version's largest error (at
# least 1e-6, a unit row's rounding), but for the weights whose bf16
# rounding float32 may decide either way, each held to one of its two bf16
# neighbours (`_bf16_rounding_slack`, the smoke's rule): the card's sums
# and the plain version's may round such a weight apart. And
# the kernel does round the weights: its mean error against the rounded
# function is below its mean error against the unrounded one.
def _bf16_kernel_against_float64(cuda, n, e, b):
    rng = np.random.RandomState(13)
    x = torch.from_numpy(_clustered(rng, b, n, e)).to(cuda)
    cols = ck.step_columns(x, True)
    for bw in (0.05, 0.15, 0.3):
        bws = torch.full((b,), bw, device=cuda)
        inv_b2 = 1.0 / (bws * bws)
        if b == 1:
            before = ck.mean_shift_step.launches_bf16
            got = ck.mean_shift_step(x[0], cols[0], bws[0], bf16=True)[None]
            assert ck.mean_shift_step.launches_bf16 == before + 1
        else:
            before = ck.mean_shift_step_batched.launches_bf16
            got = ck.mean_shift_step_batched(x, cols, bws, bf16=True)
            assert ck.mean_shift_step_batched.launches_bf16 == before + 1
        plain = ck.mean_shift_step_plain(x, x, inv_b2, bf16=True)
        exact = ck.mean_shift_step_plain(x.double(), x.double(),
                                         inv_b2.double(), bf16=True)
        assert got.shape == x.shape and got.dtype == torch.float32
        err = (got.double() - exact).abs()
        _bf16_rounding_slack(f"n={n} e={e} b={b} bw={bw}", got, plain, x,
                             inv_b2)
        if n > 1 and bw > 0.05:
            xb = x.to(torch.bfloat16).double()
            unrounded = ck.mean_shift_step_plain(xb, xb, inv_b2.double())
            assert (float(err.mean())
                    < float((got.double() - unrounded).abs().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("e", [12, 32, 40, 64, 112, 140, 200, 240, 256])
@pytest.mark.parametrize("n", [1, 63, 3001])
def test_mean_shift_bf16_kernel_against_float64(cuda, n, e, b):
    _bf16_kernel_against_float64(cuda, n, e, b)


# The same rule at the main path's size: a batch of two 10000-row shapes
# at E = 128 (79 tiles of columns a shape, 158 blocks of query rows).
@pytest.mark.cuda
def test_mean_shift_bf16_kernel_against_float64_full_size(cuda):
    _bf16_kernel_against_float64(cuda, 10000, 128, 2)


# The bf16 kernel's sums run in a fixed order (its column split's partials
# in rank order): three launches give the same bits, one shape (split
# across a cluster) and a batch, whole and ragged.
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e", [(1, 10000, 128), (3, 3001, 140),
                                   (2, 777, 256), (1, 63, 32),
                                   (2, 1001, 200), (1, 3001, 112)])
def test_mean_shift_bf16_kernel_same_bits(cuda, b, n, e):
    rng = np.random.RandomState(15)
    x = torch.from_numpy(_clustered(rng, b, n, e)).to(cuda)
    bws = torch.full((b,), 0.15, device=cuda)
    outs = [ck.mean_shift_step_batched(x, ck.step_columns(x, True), bws,
                                       bf16=True) for _ in range(3)]
    xp = ck.kernel_width(x, bf16=True)
    cols = ck.step_columns(xp, True)
    outs.append(ck.mean_shift_step_batched(xp, cols, bws, bf16=True)[..., :e])
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0]).all()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


# No fallback: a width the bf16 kernel does not take raises, from the
# wrapper (above 256) and from the C entry point (40, not a multiple of
# 16), and counts no launch; so do float32 columns under bf16 (the kernel
# reads the loop's bf16 columns only).
@pytest.mark.cuda
def test_mean_shift_bf16_kernel_refuses_widths(cuda):
    from sednet_tpu_torch.ops import _build

    x = torch.nn.functional.normalize(
        torch.randn(2, 100, 264, device=cuda), dim=-1)
    bw = torch.full((2,), 0.2, device=cuda)
    before = ck.mean_shift_step_batched.launches_bf16
    with pytest.raises(ValueError):
        ck.mean_shift_step_batched(x, ck.step_columns(x, True), bw,
                                   bf16=True)
    with pytest.raises(ValueError):
        xc = x[..., :128].contiguous()
        ck.mean_shift_step_batched(xc, xc, bw, bf16=True)
    assert ck.mean_shift_step_batched.launches_bf16 == before
    xb = x[..., :40].contiguous().to(torch.bfloat16)
    out = torch.empty(2, 100, 40, device=cuda)
    ib2 = torch.full((2,), 25.0, device=cuda)
    err = _build.lib().sednet_mean_shift_step_bf16(
        xb.data_ptr(), xb.data_ptr(), ib2.data_ptr(), 2, 100, 40,
        out.data_ptr(), _build.stream_of(xb))
    assert err != 0
    with pytest.raises(RuntimeError):
        _build.check(err, "mean_shift_step")


# three_nn (ops.pointnet2) launches K1 at k = 3 with its distances: held
# to the plain top-k (`compare_with_plain`: no set differs outside a
# near-tie), euclidean distances the roots of the squared ones.
@pytest.mark.cuda
def test_three_nn_launches_k1(cuda):
    from sednet_tpu_torch.ops.pointnet2 import three_nn

    rng = np.random.RandomState(14)
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 3001, 3)).astype(
        np.float32)).to(cuda)
    before = flash_topk.launches
    dist, idx = three_nn(pts, pts[:, :1500].contiguous())
    torch.cuda.synchronize()
    assert flash_topk.launches == before + 1
    _, sq = flash_topk(pts, pts[:, :1500].contiguous(), 3,
                       return_distances=True)
    cmp = compare_with_plain(pts, pts[:, :1500], 3, idx, sq)
    assert cmp["bad_rows"] == 0, cmp
    torch.testing.assert_close(dist, torch.sqrt(sq.clamp_min(0.0)))


# K3's lowest-index rule on exact ties, where the row and column counts
# differ and where the rows fill less than one 64-row tile; a cluster's
# four blocks merge their partial maxima by the same rule.
@pytest.mark.cuda
@pytest.mark.parametrize("r,c", [(37, 3001), (2999, 130), (1, 50)])
def test_colmax_kernel_ties_ragged(cuda, r, c):
    rng = np.random.RandomState(13)
    rows, cols = _tie_heavy(rng, r, c, e=140, vocab=12)
    rt, ct = torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)
    for thresh, gain, bias in (
            (float("inf"), 1.0, np.zeros(c, np.float32)),
            (0.8, 0.0, rng.randint(0, 4, c).astype(np.float32)),
            (float("inf"), 1.0,
             np.where(rng.rand(c) < 0.3, 0.0, -np.inf).astype(np.float32)),
            (float("inf"), 1.0, np.full(c, -np.inf, np.float32))):
        bt = torch.from_numpy(bias).to(cuda)
        before = ck.colmax.launches
        bk, ik = ck.colmax(rt, ct, bt, thresh, gain)
        assert ck.colmax.launches == before + 1
        bp, ip = ck.colmax_plain(rt, ct, bt, thresh, gain)
        assert torch.equal(ik, ip)
        assert torch.equal(torch.isinf(bk), torch.isinf(bp))
        torch.testing.assert_close(bk, bp, atol=1e-5, rtol=0)


# The HPNet-enriched clustering embedding is 128 + 12 = 140 wide: K2/K2b and
# K3 run it zero-padded to 160, as any width up to 256.
@pytest.mark.cuda
@pytest.mark.parametrize("e", [140, 256])
def test_mean_shift_and_colmax_kernels_at_wide_rows(cuda, e):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(_unit(rng, 2, 3000, e)).to(cuda)
    bw = torch.tensor([0.2, 0.35], device=cuda)
    got = ck.mean_shift_step_batched(x, x, bw)
    want = ck.mean_shift_step_plain(x, x, 1.0 / (bw * bw))
    assert got.shape == x.shape and got.is_contiguous()  # feeds the next step
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(ck.mean_shift_step_batched(got, x, bw),
                               ck.mean_shift_step_plain(got, x, 1.0 / (bw * bw)),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(ck.mean_shift_step(x[0], x[0], bw[0]),
                               want[0], atol=1e-5, rtol=0)
    rows, cols = _tie_heavy(rng, 3000, 3000, e=e, vocab=40)
    r, c = torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)
    bias = torch.from_numpy(rng.randint(0, 5, 3000).astype(np.float32)).to(cuda)
    for thresh, gain in ((float("inf"), 1.0), (0.5, 0.0)):
        bk, ik = ck.colmax(r, c, bias, thresh, gain)
        bp, ip = ck.colmax_plain(r, c, bias, thresh, gain)
        torch.testing.assert_close(bk, bp, atol=1e-5, rtol=0)
        assert torch.equal(ik, ip)


# cluster_batch at the enriched width pads once and runs every step at
# 160: the same partitions as on the CPU (plain versions at 140) on
# well-separated clusters.
@pytest.mark.cuda
def test_cluster_batch_at_wide_rows_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    centers = _unit(rng, 6, 140)
    lab = rng.randint(0, 6, (2, 2000))
    x = centers[lab] + 0.03 * rng.randn(2, 2000, 140).astype(np.float32)
    x = torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))
    sels = [torch.from_numpy(rng.permutation(2000)[:1000]) for _ in range(2)]
    before = ck.mean_shift_step_batched.launches
    got, nums, _ = cluster_batch(x.to(cuda), num_samples=1000, sels=sels)
    assert ck.mean_shift_step_batched.launches > before
    want, wnums, _ = cluster_batch(x, num_samples=1000, sels=sels)
    assert torch.equal(nums, wnums)
    for g, w in zip(got.cpu().numpy(), want.numpy()):
        pairs = set(zip(g.tolist(), w.tolist()))
        assert len(pairs) == len(set(g.tolist())) == len(set(w.tolist()))


# K4 against its plain version (tolerances and the near-tie rule: see
# fused_edgeconv.compare_with_plain), at the encoder's layer shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("metric,d,c", [("points_normals", 6, 64),
                                        ("sqdist", 64, 64),
                                        ("sqdist", 64, 128),
                                        ("sqdist", 3, 48)])
def test_fused_edge_reductions_kernel_matches_plain(cuda, metric, d, c):
    rng = np.random.RandomState(5)
    geom = (np.stack([_points_normals(rng, 2000) for _ in range(2)])
            if metric == "points_normals"
            else (rng.randn(2, 2000, d) / np.sqrt(d)).astype(np.float32))
    g = torch.from_numpy(geom).to(cuda)
    a = torch.from_numpy(rng.randn(2, 2000, c).astype(np.float32)).to(cuda)
    before = fe.fused_edge_reductions.launches
    out = fe.fused_edge_reductions(g, a, 64, metric=metric)
    torch.cuda.synchronize()
    assert fe.fused_edge_reductions.launches == before + 1
    assert out[0].shape == (2, 2000, c) and out[3].shape == (2, 2000)
    cmp = fe.compare_with_plain(g, a, 64, out, metric=metric)
    assert cmp["bad_rows"] == 0, cmp
    assert cmp["swapped_rows"] <= 0.01 * cmp["rows"], cmp


@pytest.mark.cuda
def test_fused_edge_reductions_kernel_counts_every_tie(cuda):
    # integer coordinates: distances are exact, ties at the k-th are real
    rng = np.random.RandomState(6)
    g = torch.from_numpy(rng.randint(-4, 5, (1, 3000, 3)).astype(
        np.float32)).to(cuda)
    a = torch.from_numpy(rng.randn(1, 3000, 32).astype(np.float32)).to(cuda)
    mx, sm, sq, cnt = fe.fused_edge_reductions(g, a, 16)
    pmx, psm, psq, pcnt = fe.fused_edge_reductions_plain(g, a, 16)
    assert torch.equal(cnt, pcnt) and int(cnt.max()) > 16
    assert torch.equal(mx, pmx)
    torch.testing.assert_close(sm, psm, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(sq, psq, atol=1e-4, rtol=1e-5)


def _fused_holds(g, a, k, metric="sqdist"):
    """Launch K4 once; hold it to compare_with_plain (tolerances and the
    near-tie rule there) and, on every row whose count is k (no column
    outside its k nearest ties the k-th distance), to the index route
    (K1's graph, then K6) bit for bit. Returns (out, rows with a tie)."""
    before = fe.fused_edge_reductions.launches
    out = fe.fused_edge_reductions(g, a, k, metric=metric)
    torch.cuda.synchronize()
    assert fe.fused_edge_reductions.launches == before + 1
    assert out[0].shape == a.shape and out[3].shape == a.shape[:-1]
    cmp = fe.compare_with_plain(g, a, k, out, metric=metric)
    assert cmp["bad_rows"] == 0, cmp
    assert cmp["swapped_rows"] <= 0.01 * cmp["rows"], cmp
    g3, a3 = (g, a) if g.dim() == 3 else (g[None], a[None])
    sm, sq, mx = gather_reduce(a3, flash_topk(g3, g3, k, metric=metric))
    cnt = out[3] if g.dim() == 3 else out[3][None]
    assert int(cnt.min()) >= k
    plain = cnt == k
    for got, want in zip(out[:3], (mx, sm, sq)):
        got = got if g.dim() == 3 else got[None]
        assert torch.equal(got[plain], want[plain])
    return out, int((~plain).sum())


def _grid(rng, *shape):
    """Integer coordinates: distances exact in float32 on either path, so
    ties at the k-th distance are real."""
    return rng.randint(-2, 3, shape).astype(np.float32)


# K4 at ragged N = 2003 over its list lengths (k = 16, 50, 64, 128), widths
# (C = 32 .. 256, D = 3 and 6 on the CUDA cores, 64 to 256 on the tensor
# cores) and batches (1, 2, 8); 2-D calls of one shape take the column
# split (a cluster of 2 or 4 blocks a row block).
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,c,k,metric", [
    (1, 3, 32, 16, "sqdist"), (2, 6, 64, 50, "points_normals"),
    (8, 64, 128, 64, "sqdist"), (2, 128, 256, 128, "sqdist"),
    (8, 3, 256, 128, "sqdist"), (2, 64, 32, 50, "sqdist"),
    (None, 64, 64, 64, "sqdist"), (None, 6, 128, 128, "points_normals"),
    (None, 128, 64, 16, "sqdist"), (2, 256, 64, 64, "sqdist")])
def test_fused_edge_reductions_kernel_shapes(cuda, b, d, c, k, metric):
    rng = np.random.RandomState(11)
    lead = (b,) if b else ()
    n = 2003
    geom = (np.stack([_points_normals(rng, n) for _ in range(b or 1)])
            if metric == "points_normals"
            else (rng.randn(b or 1, n, d) / np.sqrt(d)).astype(np.float32))
    g = torch.from_numpy(geom.reshape(*lead, n, d)).to(cuda)
    a = torch.from_numpy(rng.randn(*lead, n, c).astype(np.float32)).to(cuda)
    _fused_holds(g, a, k, metric)


# Exact ties on both paths, one shape and a batch, a 2-D call with the
# column split and a list longer than k (k = 50): every row whose set
# exceeds k is found, and counts and maxima equal the plain version's.
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,k", [(None, 3, 50), (2, 3, 16),
                                   (None, 16, 64), (2, 16, 50)])
def test_fused_edge_reductions_kernel_ties_on_both_paths(cuda, b, d, k):
    rng = np.random.RandomState(12)
    lead = (b,) if b else ()
    g = torch.from_numpy(_grid(rng, *lead, 2003, d)).to(cuda)
    a = torch.from_numpy(rng.randn(*lead, 2003, 64).astype(np.float32)).to(
        cuda)
    mx, sm, sq, cnt = fe.fused_edge_reductions(g, a, k)
    pmx, psm, psq, pcnt = fe.fused_edge_reductions_plain(g, a, k)
    assert torch.equal(cnt, pcnt) and int((cnt > k).sum()) > 0
    assert torch.equal(mx, pmx)
    tol = 1e-5 * float(pcnt.max()) * float(a.abs().max())
    torch.testing.assert_close(sm, psm, atol=tol, rtol=0)
    torch.testing.assert_close(sq, psq, atol=tol * float(a.abs().max()),
                               rtol=0)


# Flagged and unflagged rows in one block of 64 rows: even rows on an
# integer grid (tied), odd rows off it (no tie); the block rescans its
# flagged rows and leaves the others as phase 2 wrote them.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16])
def test_fused_edge_reductions_kernel_mixed_block(cuda, d):
    rng = np.random.RandomState(13)
    geom = _grid(rng, 2003, d)
    geom[1::2] += rng.uniform(0.2, 0.8, (1001, d)).astype(np.float32)
    g = torch.from_numpy(geom).to(cuda)
    a = torch.from_numpy(rng.randn(2003, 96).astype(np.float32)).to(cuda)
    out, tied = _fused_holds(g, a, 32)
    block = out[3][:64]
    assert tied > 0 and int((block > 32).sum()) > 0
    assert int((block == 32).sum()) > 0
    pcnt = fe.fused_edge_reductions_plain(g, a, 32)[3]
    assert torch.equal(out[3], pcnt)


# A few ties in a float cloud, as the encoder's layers have them (a few
# rows in 10000): 40 points duplicated elsewhere, so the rows whose k-th
# neighbour is one of a pair tie it. Blocks with at most 8 such rows sum
# their tied columns in shared memory, split 8 ways over the columns;
# their rows hold against the plain version, the others equal the index
# route bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,k", [(None, 3, 32), (2, 64, 64),
                                   (8, 6, 64)])
def test_fused_edge_reductions_kernel_sparse_ties(cuda, b, d, k):
    rng = np.random.RandomState(14)
    lead = (b,) if b else ()
    n = 2003
    geom = (np.stack([_points_normals(rng, n) for _ in range(b or 1)])
            if d == 6 else rng.randn(b or 1, n, d).astype(np.float32))
    for g1 in geom:
        src = rng.choice(n, 40, replace=False)
        dst = rng.choice(np.setdiff1d(np.arange(n), src), 40, replace=False)
        g1[dst] = g1[src]
    g = torch.from_numpy(geom.reshape(*lead, n, d)).to(cuda)
    a = torch.from_numpy(rng.randn(*lead, n, 64).astype(np.float32)).to(
        cuda)
    metric = "points_normals" if d == 6 else "sqdist"
    out, tied = _fused_holds(g, a, k, metric)
    per_block = (out[3].reshape(-1, n) > k).float()
    per_block = torch.nn.functional.pad(per_block, (0, 2048 - n))
    per_block = per_block.reshape(per_block.shape[0], -1, 64).sum(-1)
    assert tied > 0 and int(((per_block > 0) & (per_block <= 8)).sum()) > 0
    # a tie of two copies of one point is exact in both versions
    pmx, psm, psq, pcnt = fe.fused_edge_reductions_plain(g, a, k,
                                                         metric=metric)
    rows = out[3] > k
    assert torch.equal(out[3][rows], pcnt[rows])
    assert torch.equal(out[0][rows], pmx[rows])
    tol = 1e-5 * float(pcnt.max()) * float(a.abs().max())
    torch.testing.assert_close(out[1][rows], psm[rows], atol=tol, rtol=0)
    torch.testing.assert_close(out[2][rows], psq[rows],
                               atol=tol * float(a.abs().max()), rtol=0)


# K6 against its plain version: int64 indices with out-of-range entries
# (clamped within their shape), N = 2003 not a multiple of the 8 rows of a
# block, K = 64 and a ragged K = 50. The max is of the same elements, so
# exact; the sums add K terms in k order against torch's reduction order,
# within 1e-5 * K * max|a| (and max|a|^2), the reassociation bound.
@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(64, 64), (128, 64), (96, 50)])
def test_gather_reduce_kernel_matches_plain(cuda, c, k):
    rng = np.random.RandomState(9)
    n = 2003
    a = torch.from_numpy(rng.randn(2, n, c).astype(np.float32)).to(cuda)
    idx = rng.randint(0, n, (2, n, k))
    idx[0, :9, 0] = -5
    idx[1, 4, :3] = n + 17
    idx = torch.from_numpy(idx).to(cuda)
    before = gather_reduce.launches
    s, sq, mx = gather_reduce(a, idx)
    torch.cuda.synchronize()
    assert gather_reduce.launches == before + 1
    ps, psq, pmx = gather_reduce_plain(a, idx)
    amax = float(a.abs().max())
    assert torch.equal(mx, pmx)
    assert float((s - ps).abs().max()) <= 1e-5 * k * amax
    assert float((sq - psq).abs().max()) <= 1e-5 * k * amax * amax


# K6 walks its rows along the caller's order (runs of 64 positions a block),
# but every row is computed the same way whatever block holds it: the
# outputs are the same bits under the identity (None or written out), the
# Morton order of the points, a random and the reversed permutation, at
# every compiled width (C = 96 runs at 96 = 3 x 32; C = 32 one column a
# lane), K from 1 to 128, B = 3 and N = 2003, not a multiple of the run.
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33, 64, 128])
@pytest.mark.parametrize("c", [32, 96, 128, 256])
def test_gather_reduce_kernel_same_bits_under_every_order(cuda, c, k):
    rng = np.random.RandomState(c + k)
    b, n = 3, 2003
    a = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, n, (b, n, k))).to(cuda)
    xyz = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32)).to(cuda)
    orders = {
        "identity": torch.arange(n, dtype=torch.int32).expand(b, n),
        "random": torch.from_numpy(np.stack([rng.permutation(n)
                                             for _ in range(b)])),
        "reversed": torch.arange(n - 1, -1, -1, dtype=torch.int32).expand(
            b, n)}
    orders = {name: o.to(torch.int32).contiguous().to(cuda)
              for name, o in orders.items()}
    orders["morton"] = locality_order(xyz)
    want = gather_reduce(a, idx)
    for name, order in orders.items():
        before = gather_reduce.launches
        got = gather_reduce(a, idx, order)
        torch.cuda.synchronize()
        assert gather_reduce.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
    ps, psq, pmx = gather_reduce_plain(a, idx)
    amax = float(a.abs().max())
    assert torch.equal(want[2], pmx)
    assert float((want[0] - ps).abs().max()) <= 1e-5 * k * amax
    assert float((want[1] - psq).abs().max()) <= 1e-5 * k * amax * amax


# An order of the wrong shape, type or device raises on the card as on the
# CPU; no wrapper gives way to the plain version.
@pytest.mark.cuda
def test_gather_reduce_kernel_rejects_a_bad_order(cuda):
    rng = np.random.RandomState(12)
    a = torch.from_numpy(rng.randn(2, 300, 64).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, 300, (2, 300, 16))).to(cuda)
    good = torch.arange(300, dtype=torch.int32, device=cuda).expand(2, 300)
    before = gather_reduce.launches
    for bad in (good[:, :299], good[0], good.long(), good.cpu()):
        with pytest.raises(ValueError, match="order"):
            gather_reduce(a, idx, bad)
    assert gather_reduce.launches == before


def _bwd_inputs(cuda, seed, b, n, c, k, ties):
    """A table (dense ties: values in {-2 .. 2}), a graph with repeated
    neighbours and out-of-range entries, K6's max on it, and three
    cotangents, on the card."""
    rng = np.random.RandomState(seed)
    a = (rng.randint(-2, 3, (b, n, c)) if ties
         else rng.randn(b, n, c)).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k))
    if k > 1:
        idx[:, ::3, 1] = idx[:, ::3, 0]
    idx[0, :9, 0] = -5
    idx[-1, 4, :min(k, 3)] = n + 17
    a = torch.from_numpy(a).to(cuda)
    idx = torch.from_numpy(idx).to(cuda)
    cot = [torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(cuda)
           for _ in range(3)]
    return a, idx, gather_reduce_plain(a, idx)[2], cot


def _bwd_holds(a, idx, mx, cot, order=None):
    """Launch K6b once and hold it to its plain version run on the CPU
    copies of the inputs: every element within backward_error_bound, and
    the same bits."""
    before = gather_reduce_backward.launches
    da = gather_reduce_backward(a, idx, mx, *cot, order=order)
    torch.cuda.synchronize()
    assert gather_reduce_backward.launches == before + 1
    cpu = [t.cpu() for t in (a, idx, mx, *cot)]
    want = gather_reduce_backward_plain(*cpu)
    bound = backward_error_bound(*cpu)
    got = da.cpu()
    err = (got.double() - want.double()).abs()
    assert da.shape == a.shape and bool((err <= bound).all()), (
        float(err.max()), float(bound.max()))
    assert torch.equal(got, want)
    return da


# K6b against its plain version: widths 32-256, padded ones among them (50,
# 100, 200 run at 64, 128, 224), K from 1 to 128, B = 1 and 4, N = 2003 not
# a multiple of a block's run, dense ties of the max, repeated and
# out-of-range neighbours, along the Morton order of the points and the
# identity.
@pytest.mark.cuda
@pytest.mark.parametrize("b,c,k,ties", [
    (1, 32, 1, True), (4, 64, 64, False), (4, 64, 64, True),
    (1, 50, 16, True), (4, 96, 33, False), (1, 100, 128, True),
    (4, 128, 64, True), (1, 160, 64, False), (4, 200, 16, True),
    (1, 256, 128, False), (4, 256, 8, True)])
@pytest.mark.parametrize("ordered", [False, True])
def test_gather_reduce_backward_kernel_matches_plain(cuda, b, c, k, ties,
                                                     ordered):
    n = 2003
    a, idx, mx, cot = _bwd_inputs(cuda, c + k + b, b, n, c, k, ties)
    order = None
    if ordered:
        xyz = torch.rand((b, n, 3), generator=torch.Generator().manual_seed(
            c), dtype=torch.float32).to(cuda)
        order = locality_order(xyz)
    _bwd_holds(a, idx, mx, cot, order)


# K6b's transpose on the card (CUB's stable radix sort on the bits of
# B N - 1) gives the CPU's arrays bit for bit: the sorted edge ids and
# the ends; out-of-range and repeated neighbours, a hub.
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", [(1, 2003, 16), (4, 10000, 64),
                                   (3, 300, 128)])
def test_graph_transpose_on_card_matches_cpu(cuda, b, n, k):
    rng = np.random.RandomState(n + k)
    idx = rng.randint(0, n, (b, n, k))
    idx[:, ::3, 1 % k] = idx[:, ::3, 0]
    idx[0, :9, 0] = -5
    idx[-1, 4, :3] = n + 17
    idx[:, :, -1] = 7
    idx = torch.from_numpy(idx)
    want = graph_transpose(idx, n)
    got = graph_transpose(idx.to(cuda), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


# K6b sums every row of da in an order that the graph alone fixes: three
# launches give the same bits, and so do the identity (None), the Morton
# order of the points and a random permutation of each shape's rows.
@pytest.mark.cuda
@pytest.mark.parametrize("c,k,ties", [(64, 64, False), (128, 16, True),
                                      (200, 33, True)])
def test_gather_reduce_backward_kernel_same_bits_every_launch_and_order(
        cuda, c, k, ties):
    b, n = 3, 2003
    a, idx, mx, cot = _bwd_inputs(cuda, c + 3 * k, b, n, c, k, ties)
    first = gather_reduce_backward(a, idx, mx, *cot)
    for _ in range(2):
        assert torch.equal(gather_reduce_backward(a, idx, mx, *cot), first)
    rng = np.random.RandomState(c)
    xyz = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32)).to(cuda)
    perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(b)])
                            .astype(np.int32)).to(cuda)
    for order in (locality_order(xyz), perm):
        assert torch.equal(gather_reduce_backward(a, idx, mx, *cot,
                                                  order=order), first)


# A hub: one row listed by every row of its shape (in-degree N = 5000),
# walked whole by one warp like every other row: the CPU's plain version's
# bits, within the rounding bound, and the same bits on every launch and
# under every order.
@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128])
def test_gather_reduce_backward_kernel_hub(cuda, c):
    b, n, k = 2, 5000, 16
    a, idx, _, cot = _bwd_inputs(cuda, 77 + c, b, n, c, k, True)
    idx[:, :, 3] = 17
    mx = gather_reduce_plain(a, idx)[2]
    ends = graph_transpose(idx, n)[0].cpu()
    deg = torch.diff(ends, prepend=ends.new_zeros(1))
    assert int(deg.max()) >= 4096
    order = locality_order(torch.rand((b, n, 3), device=cuda))
    da = _bwd_holds(a, idx, mx, cot, order)
    for _ in range(2):
        assert torch.equal(gather_reduce_backward(a, idx, mx, *cot), da)


# A backward through K6 on a table that requires grad launches K6b once (no
# plain version in between), and its gradient is the plain version's.
@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_gather_reduce_kernel_backward_launches_k6b(cuda, ties):
    a, idx, mx, cot = _bwd_inputs(cuda, 10, 2, 300, 64, 16, ties)
    want = gather_reduce(a, idx)
    a.requires_grad_(True)
    order = locality_order(torch.rand((2, 300, 3), device=cuda))
    before = (gather_reduce.launches, gather_reduce_backward.launches)
    got = gather_reduce(a, idx, order)
    for g, w in zip(got, want):
        assert g.requires_grad and torch.equal(g.detach(), w)
    torch.autograd.backward(got, cot)
    torch.cuda.synchronize()
    assert (gather_reduce.launches, gather_reduce_backward.launches) == (
        before[0] + 1, before[1] + 1)
    plain = gather_reduce_backward_plain(a.detach(), idx, mx, *cot)
    bound = backward_error_bound(a.detach(), idx, mx, *cot)
    assert bool(((a.grad.double() - plain.double()).abs() <= bound).all())


# The edge convolution's gradients (input, conv weight, GroupNorm scale and
# bias) on the card, through K6 and K6b, against the same on the CPU
# through the plain versions: the same function, its sums in other orders.
@pytest.mark.cuda
def test_edge_conv_factored_gradients_on_card_match_cpu(cuda):
    from sednet_tpu_torch.ops.graph import edge_conv_factored

    rng = np.random.RandomState(14)
    b, n, k, c_in, c_out = 2, 500, 16, 64, 128
    cpu = {"x": rng.randn(b, n, c_in), "w": rng.randn(c_out, 2 * c_in) / 11,
           "scale": rng.uniform(-1.5, 1.5, c_out),
           "bias": rng.randn(c_out)}
    cpu = {key: torch.from_numpy(v.astype(np.float32)).requires_grad_()
           for key, v in cpu.items()}
    idx = torch.from_numpy(rng.randint(0, n, (b, n, k)))
    card = {key: v.detach().to(cuda).requires_grad_()
            for key, v in cpu.items()}
    cot = torch.from_numpy(rng.randn(b, n, c_out).astype(np.float32))
    before = gather_reduce_backward.launches
    for t, g, ix in ((cpu, cot, idx), (card, cot.to(cuda), idx.to(cuda))):
        y = edge_conv_factored(t["x"], ix, t["w"], t["scale"], t["bias"],
                               groups=2)
        y.backward(g)
    torch.cuda.synchronize()
    assert gather_reduce_backward.launches == before + 1
    for key in cpu:
        want, got = cpu[key].grad, card[key].grad.cpu()
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-4, (key, rel)


# K4's phase 2 is K6's loop along the same order: the output with the
# Morton order of the points is the output without it, bit for bit, on
# every row (tied rows included: phase 2b adds to them in rank order
# whatever phase 2's order was).
@pytest.mark.cuda
@pytest.mark.parametrize("metric,d,c", [("points_normals", 6, 64),
                                        ("sqdist", 64, 128)])
def test_fused_edge_reductions_kernel_order_keeps_bits(cuda, metric, d, c):
    rng = np.random.RandomState(d + c)
    b, n, k = 2, 2003, 64
    g = rng.randn(b, n, d).astype(np.float32)
    if metric == "points_normals":
        g[..., 3:6] /= np.linalg.norm(g[..., 3:6], axis=-1, keepdims=True)
    g = torch.from_numpy(g).to(cuda)
    a = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(cuda)
    order = locality_order(g[..., :3].contiguous())
    want = fe.fused_edge_reductions(g, a, k, metric=metric)
    got = fe.fused_edge_reductions(g, a, k, metric=metric, order=order)
    one = fe.fused_edge_reductions(g[1], a[1], k, metric=metric,
                                   order=order[1])
    torch.cuda.synchronize()
    for x, y, z in zip(got, want, one):
        assert torch.equal(x, y) and torch.equal(z, y[1])
    with pytest.raises(ValueError, match="order"):
        fe.fused_edge_reductions(g, a, k, metric=metric, order=order.long())


def _segsum_layout(kind, rng, chunk=2048):
    """Destination counts of the layouts that stress K5's chunk plan (the
    kernel's chunk is 2048 entries): one destination holding every entry;
    every destination one entry; segments ending exactly on chunk edges;
    empty destinations first and last around skewed segments; E not a
    multiple of the chunk."""
    if kind == "one_destination":
        counts = np.zeros(700, np.int64)
        counts[350] = 5 * chunk + 17
    elif kind == "every_one":
        counts = np.ones(3 * chunk + 5, np.int64)
    elif kind == "chunk_edges":
        counts = np.array([0, chunk, 0, chunk // 2, chunk // 2, 3 * chunk, 0,
                           chunk - 1, 1, 0], np.int64)
    elif kind == "empty_ends":
        counts = np.zeros(900, np.int64)
        counts[5:-5] = rng.randint(0, 40, 890)
        counts[17] = 3 * chunk + 11
    else:   # ragged
        counts = np.zeros(4000, np.int64)
        hot = rng.choice(4000, 60, replace=False)
        counts[hot] = rng.randint(1, 900, 60)
        counts[hot[:3]] = [chunk + 5, 4 * chunk - 3, 2 * chunk]
    dest = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    return dest, np.cumsum(counts).astype(np.int32), counts


SEGSUM_LAYOUTS = ["one_destination", "every_one", "chunk_edges",
                  "empty_ends", "ragged"]


# K5's chunk plan on the adversarial layouts: bit-identical across two
# launches (no float atomics; crossing segments merged in chunk order),
# exactly 0 at empty destinations, within 1e-5 of each segment's sum of
# |entries| of the plain version (the segmented scan, another order of
# pairwise adds), at m = 1 and 37.
@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 37])
@pytest.mark.parametrize("kind", SEGSUM_LAYOUTS)
def test_segsum_sorted_scan_kernel_adversarial_layouts(cuda, kind, m):
    rng = np.random.RandomState(len(kind) + m)
    dest, ends, counts = _segsum_layout(kind, rng)
    e = dest.shape[0]
    vals = (rng.randn(m, e) * 10.0 ** rng.uniform(-3, 3, (1, e))).astype(
        np.float32)
    vt, dt, et = (torch.from_numpy(x).to(cuda) for x in (vals, dest, ends))
    before = ck.segsum_sorted_scan.launches
    got = ck.segsum_sorted_scan(vt, dt, et)
    again = ck.segsum_sorted_scan(vt, dt, et)
    torch.cuda.synchronize()
    assert ck.segsum_sorted_scan.launches == before + 2
    assert got.shape == (len(counts), m) and torch.equal(got, again)
    want = ck.segsum_sorted_scan_plain(vt, dt, et)
    scale = ck.segsum_sorted_scan_plain(vt.abs(), dt, et)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    empty = torch.from_numpy(counts == 0).to(cuda)
    assert bool((got[empty] == 0).all())


def _segments(rng, n, skewed):
    """Sorted destinations: skewed as the farthest quirk makes them (a few
    destinations with thousands of entries, most empty) or uniform as a
    nearest-k graph (about 50 at every destination)."""
    if skewed:
        parts = [rng.randint(0, n, 3000), np.full(7000, 3),
                 np.full(4500, n - 2), np.full(5, 0),
                 rng.randint(n // 2, n // 2 + 40, 2000)]
    else:
        parts = [np.repeat(np.arange(n), 50)[rng.rand(50 * n) < 0.98]]
    dest = np.sort(np.concatenate(parts)).astype(np.int32)
    counts = np.bincount(dest, minlength=n)
    return dest, np.cumsum(counts).astype(np.int32), counts


# K5 against its plain version (the segmented scan): every partial in both
# is a pairwise add of the same entries in another order, so they agree
# within 1e-5 of each segment's sum of |values| (values over six decades);
# empty destinations are exactly 0, and two launches are bit-identical.
@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [True, False])
@pytest.mark.parametrize("m", [12, 36])
def test_segsum_sorted_scan_kernel_matches_plain(cuda, skewed, m):
    rng = np.random.RandomState(10)
    n = 4000
    dest, ends, counts = _segments(rng, n, skewed)
    e = dest.shape[0]
    vals = (rng.randn(m, e) * 10.0 ** rng.uniform(-3, 3, (1, e))).astype(
        np.float32)
    vt, dt, et = (torch.from_numpy(x).to(cuda) for x in (vals, dest, ends))
    before = ck.segsum_sorted_scan.launches
    got = ck.segsum_sorted_scan(vt, dt, et)
    again = ck.segsum_sorted_scan(vt, dt, et)
    torch.cuda.synchronize()
    assert ck.segsum_sorted_scan.launches == before + 2
    assert got.shape == (n, m) and torch.equal(got, again)
    want = ck.segsum_sorted_scan_plain(vt, dt, et)
    scale = ck.segsum_sorted_scan_plain(vt.abs(), dt, et)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    empty = torch.from_numpy(counts == 0).to(cuda)
    assert bool(empty.any() == skewed) and bool((got[empty] == 0).all())


# The matrix-free solver with K5 ("pallas") on the card against the same
# on the CPU, at the level that is invariant to the localised eigenvectors'
# rounding (tests/test_cluster.py:226-235): the enriched embedding's
# partition, with the ground-truth number of segments, on the fixture of
# tests/test_torch_port_matfree.py.
@pytest.mark.cuda
def test_matfree_pallas_on_card_gives_cpu_labels(cuda):
    d = make_synthetic_shape(np.random.RandomState(5), n_points=256,
                             n_segments=4)
    lab = d["labels"].astype(np.int64)
    oh = np.zeros((256, 8), np.float32)
    oh[np.arange(256), lab] = 1.0
    oh += 0.05 * np.random.RandomState(1).randn(*oh.shape)
    oh /= np.linalg.norm(oh, axis=1, keepdims=True)
    args = [torch.from_numpy(a.astype(np.float32))
            for a in (oh, d["points"], d["normals"])]
    x0 = torch.randn((256, 4), generator=torch.Generator().manual_seed(2))
    sel = torch.randperm(256, generator=torch.Generator().manual_seed(3))
    out = {}
    for dev in ("cpu", cuda):
        before = ck.segsum_sorted_scan.launches
        e = hpnet_enrich(*(a.to(dev) for a in args), x0=x0, knn=12, eig_k=4,
                         transpose_mode="pallas")
        launched = ck.segsum_sorted_scan.launches - before
        # 1 + 2 per LOBPCG step on the card (one A^T v per matvec)
        assert (launched == 0) if dev == "cpu" else (launched % 2 == 1)
        res = guard_mean_shift(e, num_samples=256, quantile=0.015,
                               iterations=30, sel=sel)
        out[str(dev)] = (res.labels.cpu().numpy(), int(res.num_clusters))
    (lc, nc), (lg, ng) = out["cpu"], out[str(cuda)]
    assert nc == ng == len(np.unique(lab))
    assert len(set(zip(lc.tolist(), lg.tolist()))) == nc


# cluster_batch through its async half (the tol exit as a flag on the
# device, every step launched) and its finalize half against the loop that
# reads each step's movement back and breaks, at the eval's shape (2 x 10000
# unit rows of E = 140, the HPNet-enriched width): the same shifted rows and
# the same labels. The blobs are tight, so the exit fires within the 50 steps.
@pytest.mark.cuda
def test_cluster_batch_async_finalize_matches_host_loop(cuda):
    import importlib

    ms = importlib.import_module("sednet_tpu_torch.cluster.mean_shift")
    rng = np.random.RandomState(0)
    centers = rng.randn(2, 8, 140)
    x = np.stack([c[rng.randint(0, 8, 10000)] for c in centers])
    x = x + 0.02 * rng.randn(*x.shape)
    x = torch.from_numpy((x / np.linalg.norm(x, axis=-1, keepdims=True))
                         .astype(np.float32)).to(cuda)
    gen = torch.Generator().manual_seed(1)
    sels = [torch.randperm(10000, generator=gen)[:5000] for _ in range(2)]
    kw = dict(num_samples=5000, quantile=0.015, iterations=50, tol=1e-6)
    pending = ms.cluster_batch_async(x, sels=sels, **kw)
    labels, nums, flags = ms.cluster_batch_finalize(pending, **kw)
    xk = ms.kernel_width(x)
    steps = []

    def step(cur):
        steps.append(1)
        return ck.mean_shift_step_batched(cur, xk, pending.bandwidth)

    shifted = ms._iterate_until(step, xk, 50, 1e-6)
    assert len(steps) < 50
    assert torch.equal(shifted, pending.shifted)
    for i in range(2):
        want, _, num = ms.nms(shifted[i], xk[i], pending.bandwidth[i].item())
        assert num <= 49 and int(nums[i]) == num
        assert torch.equal(labels[i], want)
    assert not flags["capped"].any()


# The stream (batch k+1's device half enqueued before batch k's host half,
# which runs on a side stream) gives each batch what predict_shapes gives
# it with the batch's generator.
@pytest.mark.cuda
def test_predict_shapes_stream_matches_per_batch_on_card(cuda):
    import os

    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.predict import (batch_generator, headline_shapes,
                                          load_models, predict_shapes,
                                          predict_shapes_stream)

    n = 512
    shapes, _ = headline_shapes(4, n)
    batches = [{k: np.stack([s[k] for s in shapes[i:i + 2]])
                for k in ("points", "normals", "labels", "prim")}
               for i in (0, 2)]
    cfg = Config(num_points=n, knn=16, hpnet_embed=True)
    ckpt = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "checkpoints", "bench_10k.npz")
    models = load_models(ckpt, cfg, device=cuda)
    streamed = list(predict_shapes_stream(models["type"], models["inst"],
                                          iter(batches), cfg, seed=5))
    for k, batch in enumerate(batches):
        want = predict_shapes(models["type"], models["inst"], batch, cfg,
                              generator=batch_generator(5, k))
        for g, w in zip(streamed[k], want):
            for name in ("cluster_ids", "pred_primitives", "num_clusters",
                         "guard_capped", "guard_bw_capped", "inst_iou",
                         "type_iou", "inst_recall"):
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)
            np.testing.assert_array_equal(g["edge_prob"], w["edge_prob"])


# One train step of the production model (k = 64, embed 128) on two
# 1000-point clouds: on the card it launches K1 and K6 three times each and
# K6b three times (the edge convolutions' gradients); its loss and every
# parameter's gradient agree with the same step on the CPU (the plain
# versions) on the same parameters, triplet draws and kNN graphs (the
# card's, replayed: K1's TF32 split may swap near-tie neighbours against
# the plain top-k, which moves a row's max and the gradients with it), up
# to the float association of the card's sums.
@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    import copy

    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.losses import TripletConfig
    from sednet_tpu_torch.losses.embedding import sample_draws
    from sednet_tpu_torch.models import backbone
    from sednet_tpu_torch.models.init import init_like_flax
    from sednet_tpu_torch.ops.flash_topk import flash_topk

    graphs, replay = [], []

    def record_or_replay(fn):
        def call(x, *args, **kw):
            if replay:
                return replay.pop(0).to(x.device)
            graphs.append(fn(x, *args, **kw))
            return graphs[-1]
        return call

    for name in ("knn_indices", "knn_indices_points_normals"):
        monkeypatch.setattr(backbone, name,
                            record_or_replay(getattr(backbone, name)))
    cfg = Config(num_points=1000, edge_topk=400)
    rng = np.random.RandomState(21)
    shapes = [make_synthetic_shape(rng, n_points=1000) for _ in range(2)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in shapes]))
             for k in ("points", "normals", "labels", "prim", "edges",
                       "edges_w")}
    model = init_like_flax(T.build_model(cfg),
                           torch.Generator().manual_seed(0))
    draws = sample_draws(batch["labels"], TripletConfig(
        max_segments=cfg.ms_max_clusters), torch.Generator().manual_seed(1))
    out = {}
    for name, dev, m in (("cuda", cuda, copy.deepcopy(model).to(cuda)),
                         ("cpu", "cpu", model)):
        replay[:] = graphs   # none for the card, the card's for the CPU
        before = [f.launches for f in (flash_topk, gather_reduce,
                                       gather_reduce_backward)]
        total, _ = T.make_loss_fn(m, cfg)(
            {k: v.to(dev) for k, v in batch.items()}, draws)
        total.backward()
        after = [f.launches for f in (flash_topk, gather_reduce,
                                      gather_reduce_backward)]
        out[name] = (float(total.detach()), [a - b for a, b in
                                             zip(after, before)],
                     {k: p.grad.cpu() for k, p in m.named_parameters()})
    assert out["cpu"][1] == [0, 0, 0] and out["cuda"][1] == [3, 3, 3]
    assert not replay and len(graphs) == 3
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for key, want in out["cpu"][2].items():
        rel = float((out["cuda"][2][key] - want).norm() / want.norm())
        assert rel <= 1e-3, (key, rel)


# The fit path's shape class: one cloud (B = 1) of 1000-1800 points, not a
# multiple of the block, k = 10 (a partial 32-entry list), D = 3 (the
# CUDA-core walk) and 64 / 128 (the tensor-core walk): SplineNet's graphs.
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1500, 1801])
@pytest.mark.parametrize("d", [3, 64, 128])
def test_flash_topk_kernel_spline_shapes(cuda, n, d):
    rng = np.random.RandomState(n + d)
    x = (rng.randn(1, n, d) * np.linspace(1.0, 0.1, d)).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    _topk_holds(t, t, 10)


def _fit_segments(rng):
    from sednet_tpu_torch.data.synthetic import _SAMPLERS

    segs = []
    for label, sampler in sorted(_SAMPLERS.items()):
        for n in (60, 700, 3000):
            p, nrm, _ = sampler(rng, n)
            segs.append((label, (p + rng.randn(n, 3) * 0.003).astype(
                np.float32), nrm.astype(np.float32),
                rng.uniform(0.3, 1.0, n).astype(np.float32)))
    return segs


def _canon_fit(row, label):
    """A segment's own-type slot of a packed fit, signs fixed and the
    cylinder's centre across its axis (as chip_smoke.canonical_params)."""
    name = {1: "plane", 5: "sphere", 4: "cylinder", 3: "cone"}[label]
    sl = {"plane": slice(0, 4), "sphere": slice(4, 8),
          "cylinder": slice(8, 15), "cone": slice(15, 22)}[name]
    v = np.asarray(row[sl], np.float64).copy()
    if name in ("plane", "cylinder"):
        v[:4 if name == "plane" else 3] *= np.sign(v[np.abs(v[:3]).argmax()])
    if name == "cylinder":
        a = v[:3] / np.linalg.norm(v[:3])
        v[3:6] -= (v[3:6] @ a) * a
    return v


@pytest.mark.cuda
def test_batched_fits_on_card_match_cpu(cuda):
    """The packed fits (cuSOLVER's batched SVD, the solves) against the CPU
    port's (LAPACK), own-type slots at atol 1e-3 after the sign
    canonicalisation; 500 more rows of zero weight change nothing."""
    from sednet_tpu_torch.fit.primitives import fit_all_types_packed

    segs = _fit_segments(np.random.RandomState(3))

    def packed(extra, dev):
        p_max = max(s[1].shape[0] for s in segs) + extra
        arrs = [np.zeros((len(segs), p_max, 3), np.float32),
                np.zeros((len(segs), p_max, 3), np.float32),
                np.zeros((len(segs), p_max), np.float32)]
        for i, (_, p, n, w) in enumerate(segs):
            arrs[0][i, :len(p)], arrs[1][i, :len(p)] = p, n
            arrs[2][i, :len(p)] = w
        out = fit_all_types_packed(*(torch.from_numpy(a).to(dev)
                                     for a in arrs))
        return out.cpu().numpy()

    card, cpu, card_pad = packed(0, cuda), packed(0, "cpu"), packed(500, cuda)
    assert np.isfinite(card).all()
    for i, (label, *_rest) in enumerate(segs):
        np.testing.assert_allclose(_canon_fit(card[i], label),
                                   _canon_fit(cpu[i], label), atol=1e-3)
        np.testing.assert_allclose(_canon_fit(card_pad[i], label),
                                   _canon_fit(card[i], label), atol=1e-4)


@pytest.mark.cuda
def test_splinenet_on_card_matches_cpu(cuda, monkeypatch):
    """SplineNet at full width on seeded weights, card against CPU at 1500
    points: K1's four graphs against topk_plain, then the CPU replaying the
    card's graphs (so that a near-tie swap cannot move a max), control
    grid at atol 1e-4; K1 four launches a forward."""
    from sednet_tpu_torch.models import splinenet as sn
    from sednet_tpu_torch.models.init import init_like_flax

    graphs, replay = [], []
    real = sn.knn_indices

    def record_or_replay(x, k):
        if replay:
            return replay.pop(0).to(x.device)
        graphs.append((x.detach().clone(), real(x, k)))
        return graphs[-1][1]

    monkeypatch.setattr(sn, "knn_indices", record_or_replay)
    net = init_like_flax(sn.SplineNet(), torch.Generator().manual_seed(4))
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(1, 1500, 3) * np.array(
        [1.0, 0.6, 0.05])).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.2, 1.0, (1, 1500)).astype(np.float32))
    card_net = copy.deepcopy(net).to(cuda)
    before = flash_topk.launches
    with torch.no_grad():
        got = card_net(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert flash_topk.launches == before + 4
    for xg, idx in graphs:
        again, dist = flash_topk(xg, xg, 10, return_distances=True)
        assert torch.equal(again, idx)
        cmp = compare_with_plain(xg, xg, 10, again, dist)
        assert cmp["bad_rows"] == 0 and cmp["max_abs_err"] <= cmp["tol"]
        assert cmp["swapped_rows"] <= 0.01 * cmp["rows"], cmp
    replay[:] = [idx for _, idx in graphs]
    with torch.no_grad():
        want = net(x, w)
    assert not replay
    assert torch.isfinite(got).all() and tuple(got.shape) == (1, 400, 3)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_fit_ground_truth_on_card_matches_jax_reference(cuda):
    """chip_smoke's check (a): the 8 eval clouds' true segments fitted on
    the card, each segment's residual and parameters against the numbers
    of scripts/jax_fit_reference.py that chip_smoke.py embeds."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from sednet_tpu_torch.fit import Evaluation, FittingModule
    from sednet_tpu_torch.predict import headline_shapes

    shapes, _ = headline_shapes(chip_smoke.BATCH, chip_smoke.N_POINTS)
    rec = chip_smoke.check_fit_ground_truth(
        Evaluation(FittingModule(device=cuda)), shapes)
    assert rec["ok"], rec


@pytest.mark.cuda
@pytest.mark.parametrize("closed", [False, True])
def test_spline_train_step_on_card_matches_cpu(cuda, monkeypatch, closed):
    """One SplineNet train step at full width (grid 20, 700 points, B 4),
    card against CPU, the CPU replaying the card's K1 graphs: K1 four
    launches a forward, the loss and metrics at rtol 1e-4, each gradient
    within 5e-3 relative L2 but those of the biases that feed a train-mode
    BatchNorm (0 in exact arithmetic); chamfer's backward within 1e-6."""
    from sednet_tpu_torch.fit.bspline import uniform_knot_bspline
    from sednet_tpu_torch.models import splinenet as sn
    from sednet_tpu_torch.models.init import init_like_flax
    from sednet_tpu_torch.ops.chamfer import chamfer_index
    from sednet_tpu_torch.splinenet_train import (make_spline_patches,
                                                  make_spline_train_step)

    graphs, replay = [], []
    real = sn.knn_indices

    def record_or_replay(x, k):
        if replay:
            return replay.pop(0).to(x.device)
        graphs.append(real(x, k))
        return graphs[-1]

    monkeypatch.setattr(sn, "knn_indices", record_or_replay)
    points, ctrl = make_spline_patches(n_patches=4, n_points=700, grid=20,
                                       closed=closed)
    nu, nv = uniform_knot_bspline(20, 20, 3, 3, 30)
    net = init_like_flax(sn.SplineNet(), torch.Generator().manual_seed(6))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        model = copy.deepcopy(net).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step, _ = make_spline_train_step(model, opt, nu, nv, closed=closed,
                                         loss_weight=0.9, grid=20)
        before = flash_topk.launches
        m = step(torch.from_numpy(points).to(dev),
                 torch.from_numpy(ctrl).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert flash_topk.launches == before + 4
            replay[:] = graphs
        runs.append(({k: float(v) for k, v in m.items()},
                     {n: p.grad.detach().cpu().double()
                      for n, p in model.named_parameters()}))
    assert not replay
    (cm, cg), (pm, pg) = runs
    for k in pm:
        assert abs(cm[k] - pm[k]) <= 1e-4 * abs(pm[k]), k
    for n in pg:
        if n not in ("bn5.bias", "conv6.bias", "conv7.bias"):
            err = float((cg[n] - pg[n]).norm() / pg[n].norm())
            assert err <= 5e-3, (n, err)

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 900, 3).astype(np.float32))
    y = torch.from_numpy(rng.randn(4, 700, 3).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        tx = x.to(dev).requires_grad_()
        ty = y.to(dev).requires_grad_()
        d1, d2 = chamfer_index(tx, ty)
        (d1.sum() + 2.0 * d2.sum()).backward()
        grads.append((tx.grad.cpu(), ty.grad.cpu()))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-6


# --- K1, K6 and K6b as torch.library ops ----------------------------------------
# opcheck on the card runs the CUDA implementations: their outputs against
# the fake implementations' shapes, dtypes and strides, the schema, the
# autograd registration and AOT dispatch with dynamic shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("metric,d", [("sqdist", 64), ("points_normals", 6),
                                      ("sqdist", 20)])
def test_custom_op_topk_on_card(cuda, metric, d):
    rng = np.random.RandomState(41)
    x = (np.stack([_points_normals(rng, 1500) for _ in range(2)])
         if metric == "points_normals" else
         rng.randn(2, 1500, d).astype(np.float32))
    q = torch.from_numpy(x).to(cuda)
    before = flash_topk.launches
    dist, idx = torch.ops.sednet.topk(q, q, 32, metric, 1.0, False)
    torch.cuda.synchronize()
    assert flash_topk.launches == before + 1
    cmp = compare_with_plain(q, q, 32, idx, dist, metric=metric)
    assert cmp["bad_rows"] == 0 and cmp["max_abs_err"] <= cmp["tol"], cmp
    torch.library.opcheck(torch.ops.sednet.topk.default,
                          (q, q, 32, metric, 1.0, False))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 100])
def test_custom_op_gather_reduce_on_card(cuda, c):
    """K6 and, through the op's autograd formula, K6b on the card: the
    forward against gather_reduce_plain (the same k order; 1e-6 of the
    values' scale), the backward within backward_error_bound of
    gather_reduce_backward_plain; each op launched once; opcheck on both
    (C = 100 pads to 128 and slices back)."""
    rng = np.random.RandomState(42)
    a = torch.from_numpy(rng.randn(2, 2000, c).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, 2000, (2, 2000, 16))).to(cuda)
    order = locality_order(a[..., :3].contiguous())
    before = (gather_reduce.launches, gather_reduce_backward.launches)
    x = a.clone().requires_grad_()
    out = gather_reduce(x, idx, order)
    cot = [torch.randn(a.shape, device=cuda) for _ in range(3)]
    torch.autograd.backward(out, cot)
    torch.cuda.synchronize()
    assert (gather_reduce.launches, gather_reduce_backward.launches) == (
        before[0] + 1, before[1] + 1)
    for got, want in zip(out, gather_reduce_plain(a, idx)):
        assert got.is_contiguous()
        assert float((got.detach() - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    mx = out[2].detach()
    want = gather_reduce_backward_plain(a, idx, mx, *cot)
    bound = backward_error_bound(a, idx, mx, *cot)
    assert bool(((x.grad - want).abs() <= bound).all())
    torch.library.opcheck(torch.ops.sednet.gather_reduce.default,
                          (a.clone().requires_grad_(), idx, order))
    torch.library.opcheck(torch.ops.sednet.gather_reduce_backward.default,
                          (a, idx, order, mx, *cot))


@pytest.mark.cuda
def test_export_on_card_launches_the_kernels(cuda, tmp_path):
    """A bundle exported on the card: its forward equals the model's
    (1e-6), launches K1 and K6 three times each, and a second process's
    worth of loading (torch.export.load) runs it without the model."""
    from sednet_tpu_torch import export
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.models.init import init_like_flax
    from sednet_tpu_torch.train import build_model

    cfg = Config(num_points=1000, batch_size=2)
    model = init_like_flax(build_model(cfg),
                           torch.Generator().manual_seed(3)).to(cuda).eval()
    export.export_serving_bundle(cfg, model, model, str(tmp_path),
                                 device=cuda)
    _, fns = export.load_bundle(str(tmp_path), device=cuda)
    rng = np.random.RandomState(43)
    x = torch.from_numpy(np.stack([_points_normals(rng, 1000)
                                   for _ in range(2)])).to(cuda)
    before = (flash_topk.launches, gather_reduce.launches)
    with torch.no_grad():
        got = fns["inst_model"](x)
        torch.cuda.synchronize()
        after = (flash_topk.launches, gather_reduce.launches)
        ref = model(x)
    assert (after[0] - before[0], after[1] - before[1]) == (3, 3)
    for name in ("embedding", "type_log_prob", "edge_logits"):
        assert float((got[name] - getattr(ref, name)).abs().max()) <= 1e-6


# K1 with its column-id table: the columns of p permuted, the permutation
# as the ids, lists the unpermuted answer bit for bit (ties to the lower
# original index, on tie-heavy rows too), one shape and a batch, both
# metrics and largest; and `spatial_sort` (the locality order of rows and
# columns, the table the sorted columns' original indices) gives the
# unsorted call's indices and distances.
@pytest.mark.cuda
@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("d,metric,k", [(3, "sqdist", 50), (6, "points_normals", 64),
                                        (64, "sqdist", 64), (140, "sqdist", 128)])
def test_topk_column_ids_sorted_and_unsorted(cuda, d, metric, k, largest):
    rng = np.random.RandomState(21)
    if metric == "points_normals":
        x = np.stack([_points_normals(rng, 2003) for _ in range(2)])
    else:
        x = rng.randn(2, 2003, d).astype(np.float32)
        x[:, 1000:1100] = x[:, :100]          # whole rows repeat: ties
    q = torch.from_numpy(x).to(cuda)
    i0, d0 = flash_topk(q, q, k, metric=metric, largest=largest,
                        spatial_sort=False, return_distances=True)
    perm = torch.from_numpy(np.stack([rng.permutation(2003)
                                      for _ in range(2)])).to(cuda)
    qp = torch.gather(q, 1, perm[..., None].expand(-1, -1, q.shape[-1]))
    before = flash_topk.launches
    d1, i1 = torch.ops.sednet.topk(q, qp.contiguous(), k, metric, 1.0,
                                   largest, perm.to(torch.int32).contiguous())
    assert flash_topk.launches == before + 1
    assert torch.equal(i1, i0) and torch.equal(d1, d0)
    i2, d2 = flash_topk(q, q, k, metric=metric, largest=largest,
                        spatial_sort=True, return_distances=True)
    assert torch.equal(i2, i0) and torch.equal(d2, d0)
    cmp = compare_with_plain(q, q, k, i2, d2, metric=metric, largest=largest)
    assert cmp["bad_rows"] == 0, cmp
    # one shape, p shared
    i3 = flash_topk(q[0], q[0], k, metric=metric, largest=largest,
                    spatial_sort=True)
    assert torch.equal(i3, i0[0])


# The model_bf16 forward on the card against the CPU's bf16 forward on the
# same parameters and the card's graphs: both float32 outputs; the card
# within twice the CPU bf16 forward's distance from the CPU float64
# forward (the two bf16 stacks round apart by an ulp here and there).
@pytest.mark.cuda
def test_model_bf16_forward_on_card_matches_cpu(cuda):
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.models.sednet import SEDNet

    torch.manual_seed(0)
    model = SEDNet.from_config(Config(knn=16, model_bf16=True))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.2)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(np.stack([_points_normals(rng, 2000)
                                   for _ in range(2)]))
    graphs = []
    card = copy.deepcopy(model).to(cuda)
    for i in (1, 2, 3):    # the card's three graphs, K1's
        getattr(card.encoder, f"conv{i}").register_forward_hook(
            lambda m, a, o: graphs.append(a[1].cpu()))
    with torch.no_grad():
        got = card(x.to(cuda))
        cpu = model(x, graphs=graphs)
        m64 = copy.deepcopy(model).double()
        for mod in m64.modules():
            if hasattr(mod, "dtype") and not isinstance(mod, torch.Tensor):
                mod.dtype = torch.float64
        ref = m64(x.double(), graphs=graphs)
    for name in ("embedding", "type_log_prob", "edge_logits"):
        g, c, r = (getattr(o, name) for o in (got, cpu, ref))
        assert g.dtype == c.dtype == torch.float32
        d_card = float((g.cpu().double() - r).abs().max())
        d_cpu = float((c.double() - r).abs().max())
        assert d_card <= 2.0 * d_cpu, (name, d_card, d_cpu)


# ring_knn on a one-rank NCCL group: K1 itself, bit for bit.
@pytest.mark.cuda
def test_ring_knn_world_size_one_is_k1(cuda, tmp_path):
    import torch.distributed as dist

    from sednet_tpu_torch.parallel import init_mesh, ring_knn

    rng = np.random.RandomState(4)
    mesh = init_mesh(0, 1, str(tmp_path), device=cuda)
    try:
        for x, metric in ((_points_normals(rng, 3001), "points_normals"),
                          (rng.randn(3001, 64).astype(np.float32), "sqdist")):
            t = torch.from_numpy(x).to(cuda)
            before = flash_topk.launches
            idx, dist_ = ring_knn(t, 32, mesh, metric=metric)
            assert flash_topk.launches == before + 1
            want = flash_topk(t, t, 32, metric=metric, return_distances=True)
            assert torch.equal(idx, want[0]) and torch.equal(dist_, want[1])
    finally:
        dist.destroy_process_group()


# K2 on a row shard (M query rows against all N columns, the sharded
# shift's step): each row the bits of the whole shape's step, and within
# atol 1e-5 of the float32 plain version, as the square step is held.
@pytest.mark.cuda
@pytest.mark.parametrize("m,n,e", [(2500, 10000, 128), (333, 1001, 140),
                                   (64, 65, 32)])
def test_mean_shift_step_row_shard(cuda, m, n, e):
    rng = np.random.RandomState(17)
    x = torch.from_numpy(_clustered(rng, 1, n, e)[0]).to(cuda)
    bw = torch.tensor(0.15, device=cuda)
    r0 = (n - m) // 2
    before = ck.mean_shift_step.launches
    part = ck.mean_shift_step(x[r0:r0 + m].contiguous(), x, bw)
    whole = ck.mean_shift_step(x, x, bw)
    assert ck.mean_shift_step.launches == before + 2
    assert part.shape == (m, e)
    assert torch.equal(part, whole[r0:r0 + m])
    plain = ck.mean_shift_step_plain(x[None, r0:r0 + m], x[None],
                                     (1.0 / (bw * bw)).reshape(1))[0]
    torch.testing.assert_close(part, plain, atol=1e-5, rtol=0)


# The LOBPCG iteration replayed as CUDA graphs (`cluster/lobpcg.py`): a
# key's first solve runs eagerly, its second captures and replays. The
# replayed kernels are the eager ones, so every solve is the eager bits.
def _affinity(seed, n, device):
    from sednet_tpu_torch.cluster.spectral import normal_affinity_topk

    d = make_synthetic_shape(np.random.RandomState(seed), n_points=n)
    xyz, nrm = (torch.from_numpy(d[k].astype(np.float32)).to(device)
                for k in ("points", "normals"))
    return normal_affinity_topk(xyz, nrm)


def _start_block(seed, n, k=12):
    return torch.randn((n, k), generator=torch.Generator().manual_seed(seed))


@pytest.fixture
def replays():
    from sednet_tpu_torch.cluster import lobpcg

    lobpcg._REPLAYS.clear()
    yield lobpcg
    lobpcg._REPLAYS.clear()


@pytest.mark.cuda
def test_lobpcg_replay_is_the_eager_solve_bit_for_bit(cuda, replays):
    from torch.profiler import ProfilerActivity, profile

    n = 10000
    for seed in (0, 1):
        a = _affinity(seed, n, cuda)
        x0 = _start_block(seed, n).to(cuda)
        replays._REPLAYS.clear()
        eager = replays.lobpcg_standard(a, x0, m=10)
        assert not replays._REPLAYS.replays
        captured = replays.lobpcg_standard(a, x0, m=10)
        assert len(replays._REPLAYS.replays) == 1
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            replayed = replays.lobpcg_standard(a, x0, m=10)
        names = {e.key for e in prof.key_averages()}
        assert f"lobpcg/replayed={eager[2]}" in names
        for got in (captured, replayed):
            assert got[2] == eager[2]
            assert torch.equal(got[0], eager[0])
            assert torch.equal(got[1], eager[1])


@pytest.mark.cuda
def test_lobpcg_replays_return_the_callers_own_tensors(cuda, replays):
    n = 4000
    a, b = _affinity(2, n, cuda), _affinity(3, n, cuda)
    x0 = _start_block(2, n).to(cuda)
    replays.lobpcg_standard(a, x0, m=10)
    theta_a, u_a, _ = replays.lobpcg_standard(a, x0, m=10)
    assert len(replays._REPLAYS.replays) == 1
    kept = (theta_a.clone(), u_a.clone())
    theta_b, u_b, _ = replays.lobpcg_standard(b, x0, m=10)
    assert not torch.equal(u_a, u_b)
    assert torch.equal(theta_a, kept[0]) and torch.equal(u_a, kept[1])


@pytest.mark.cuda
def test_lobpcg_key_seen_once_captures_nothing(cuda, replays):
    n = 3000
    a = _affinity(4, n, cuda)
    x0 = _start_block(4, n).to(cuda)
    replays.lobpcg_standard(a, x0, m=10)
    assert not replays._REPLAYS.replays and not replays._REPLAYS.failed
    # another shape is another key; a callable operator never captures
    replays.lobpcg_standard(a[:2999, :2999].contiguous(), x0[:2999], m=10)
    for _ in range(2):
        replays.lobpcg_standard(lambda v: a @ v, x0, m=10)
    assert not replays._REPLAYS.replays and not replays._REPLAYS.failed
