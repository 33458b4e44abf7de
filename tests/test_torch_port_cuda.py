"""The CUDA kernels of sednet_tpu_torch against their plain PyTorch
versions, on the card. Without an NVIDIA GPU every test here skips: a CUDA
kernel has no CPU mode. This file imports no JAX, so that it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py -q
"""
import numpy as np
import pytest
import torch

from sednet_tpu_torch.ops import cuda_kernels as ck
from sednet_tpu_torch.ops import fused_edgeconv as fe
from sednet_tpu_torch.cluster import cluster_batch
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


@pytest.mark.cuda
@pytest.mark.parametrize("metric,d,k,largest", [
    ("sqdist", 64, 64, False), ("points_normals", 6, 64, False),
    ("sqdist", 128, 128, False), ("sqdist", 16, 16, True),
    ("sqdist", 3, 50, True)])
def test_flash_topk_kernel_matches_plain(cuda, metric, d, k, largest):
    rng = np.random.RandomState(1)
    x = np.stack([_points_normals(rng, 2000) for _ in range(2)]) \
        if metric == "points_normals" else \
        (rng.randn(2, 2000, d) / np.sqrt(d)).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    before = flash_topk.launches
    idx, dist = flash_topk(t, t, k, metric=metric, largest=largest,
                           return_distances=True)
    torch.cuda.synchronize()
    assert flash_topk.launches == before + 1
    # tolerances and the near-tie rule: see compare_with_plain
    cmp = compare_with_plain(t, t, k, idx, dist, metric=metric,
                             largest=largest)
    assert cmp["bad_rows"] == 0 and cmp["max_abs_err"] <= cmp["tol"], cmp
    assert cmp["nbr_err"] <= cmp["tol"], cmp
    assert cmp["swapped_rows"] <= 0.01 * cmp["rows"], cmp


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
