"""The port's kernels (sednet_tpu_torch.ops) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX functions (Pallas kernels in interpret mode, and the XLA
top-k path) on the same numpy inputs. The CUDA kernels themselves are held
against the plain versions in test_torch_port_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.ops.flash_topk import topk_pallas
from sednet_tpu.ops.knn import knn_indices, knn_indices_points_normals
from sednet_tpu.ops.pallas_kernels import (colmax_pallas,
                                           mean_shift_step_pallas,
                                           mean_shift_step_pallas_batched)
from sednet_tpu_torch.ops import cuda_kernels as ck
from sednet_tpu_torch.ops.flash_topk import (compare_with_plain, flash_topk,
                                             topk_plain)
from sednet_tpu_torch.ops.knn import knn_indices as knn_port
from sednet_tpu_torch.ops.knn import \
    knn_indices_points_normals as knn_pn_port


def _points_normals(rng, n):
    x = rng.randn(n, 6).astype(np.float32)
    x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    return x


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _same_sets(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return all(set(r) == set(s) for r, s in zip(
        a.reshape(-1, a.shape[-1]).tolist(), b.reshape(-1, b.shape[-1]).tolist()))


# Neighbour sets must be equal: random inputs have no ties within float32
# rounding at these sizes. Points are scaled to norms of order 1, like the
# normalised clouds, so the |q|^2 + |p|^2 - 2 q.p expansion rounds at
# ~1e-7 and distances are compared at atol 1e-5.
@pytest.mark.parametrize("metric,d,k,largest", [
    ("sqdist", 16, 16, False), ("sqdist", 16, 128, False),
    ("points_normals", 6, 16, False), ("points_normals", 6, 128, False),
    ("sqdist", 16, 16, True)])
def test_topk_plain_matches_topk_pallas(rng, metric, d, k, largest):
    x = _points_normals(rng, 200) if metric == "points_normals" else \
        (0.25 * rng.randn(200, d)).astype(np.float32)
    idx_j, dist_j = topk_pallas(jnp.asarray(x), jnp.asarray(x), k,
                                metric=metric, largest=largest,
                                return_distances=True, interpret=True,
                                spatial_sort=False, col_halves=1)
    t = torch.from_numpy(x)
    idx_t, dist_t = flash_topk(t, t, k, metric=metric, largest=largest,
                               return_distances=True)
    assert idx_t.dtype == torch.int64 and idx_t.shape == (200, k)
    assert _same_sets(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), atol=1e-5)


@pytest.mark.parametrize("k", [16, 128])
def test_knn_matches_hier(rng, k):
    x = rng.randn(2, 300, 16).astype(np.float32)
    want = knn_indices(jnp.asarray(x), k, method="hier")
    got = knn_port(torch.from_numpy(x), k)
    assert got.shape == (2, 300, k)
    for b in range(2):
        assert _same_sets(got[b].numpy(), want[b])


def test_knn_points_normals_matches_hier(rng):
    x = np.stack([_points_normals(rng, 300) for _ in range(2)])
    want = knn_indices_points_normals(jnp.asarray(x), 16,
                                      normal_metric_w=0.5, method="hier")
    got = knn_pn_port(torch.from_numpy(x), 16, normal_metric_w=0.5)
    for b in range(2):
        assert _same_sets(got[b].numpy(), want[b])


def test_knn_dilation_matches(rng):
    x = rng.randn(1, 300, 8).astype(np.float32)
    want = knn_indices(jnp.asarray(x), 8, 32, method="hier")
    got = knn_port(torch.from_numpy(x), 8, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_plain_ties_take_lowest_index():
    p = np.zeros((10, 4), np.float32)
    p[[2, 5, 7]] = 1.0          # two groups of equidistant columns
    q = np.full((1, 4), 0.25, np.float32)
    d, i = topk_plain(torch.from_numpy(q), torch.from_numpy(p), 10)
    assert i[0].tolist()[:7] == [0, 1, 3, 4, 6, 8, 9]
    assert i[0].tolist()[7:] == [2, 5, 7]


# compare_with_plain, the check the CUDA top-k is held to on the card:
# a swap inside an exact tie passes, a wrong neighbour does not.
def test_compare_with_plain_accepts_swaps_within_ties():
    p = np.zeros((10, 4), np.float32)
    p[[2, 5, 7]] = 1.0
    q = torch.full((1, 4), 0.25)
    p = torch.from_numpy(p)
    d, i = topk_plain(q, p, 8)
    cmp = compare_with_plain(q, p, 8, i, d)
    assert cmp["swapped_rows"] == 0 and cmp["nbr_err"] == 0.0
    swapped = i.clone()
    swapped[0, 7] = 5           # column 5 is as far as column 2
    cmp = compare_with_plain(q, p, 8, swapped, d)
    assert cmp["swapped_rows"] == 1 and cmp["tie_rows"] == 1
    assert cmp["bad_rows"] == 0 and cmp["nbr_err"] == 0.0


def test_compare_with_plain_flags_wrong_neighbours(rng):
    t = torch.from_numpy((0.25 * rng.randn(2, 200, 16)).astype(np.float32))
    d, i = topk_plain(t, t, 16)
    wrong = i.clone()
    wrong[1, 3, 0] = torch.argmax(((t[1] - t[1, 3]) ** 2).sum(-1))  # farthest
    cmp = compare_with_plain(t, t, 16, wrong, d)
    assert cmp["swapped_rows"] == 1 and cmp["rows"] == 400
    assert cmp["bad_rows"] + cmp["tie_rows"] >= 1
    assert cmp["nbr_err"] > cmp["tol"] and cmp["max_abs_err"] == 0.0


# The step's exp argument is <= 0 and the output is unit-norm; the plain
# version and the Pallas kernel differ only by summation order (atol 1e-5).
def test_mean_shift_step_plain_matches_pallas(rng):
    x = _unit(rng, 200, 32)
    q = _unit(rng, 200, 32)
    want = mean_shift_step_pallas(jnp.asarray(q), jnp.asarray(x),
                                  jnp.float32(0.4), row_block=64,
                                  col_block=128, interpret=True)
    got = ck.mean_shift_step(torch.from_numpy(q), torch.from_numpy(x), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mean_shift_step_batched_plain_matches_pallas(rng):
    x = _unit(rng, 3, 150, 16)
    q = _unit(rng, 3, 150, 16)
    bw = np.array([0.2, 0.5, 1.0], np.float32)
    want = mean_shift_step_pallas_batched(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(bw), row_block=64,
        col_block=128, interpret=True)
    got = ck.mean_shift_step_batched(torch.from_numpy(q), torch.from_numpy(x),
                                     torch.from_numpy(bw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _tie_heavy(rng, r, c, e=16, vocab=7):
    voc = _unit(rng, vocab, e)
    return voc[rng.randint(0, vocab, r)], voc[rng.randint(0, vocab, c)]


# Rows and columns drawn from a small vocabulary: every similarity is an
# exact duplicate of many others, so the lowest-index rule decides almost
# every row. Indices must be equal exactly; values at atol 1e-6.
@pytest.mark.parametrize("case", ["membership", "vote", "assign", "empty"])
def test_colmax_plain_matches_pallas_on_ties(rng, case):
    rows, cols = _tie_heavy(rng, 200, 260)
    c = cols.shape[0]
    thresh, gain, bias = {
        "membership": (np.inf, 1.0, np.zeros(c, np.float32)),
        "vote": (0.8, 0.0, rng.randint(0, 4, c).astype(np.float32)),
        "assign": (np.inf, 1.0, np.where(rng.rand(c) < 0.3, 0.0, -np.inf)),
        "empty": (np.inf, 1.0, np.full(c, -np.inf)),
    }[case]
    bias = bias.astype(np.float32)
    bj, ij = colmax_pallas(jnp.asarray(rows), jnp.asarray(cols),
                           jnp.asarray(bias), jnp.float32(thresh),
                           jnp.float32(gain), row_block=64, col_block=128,
                           interpret=True)
    bt, it = ck.colmax(torch.from_numpy(rows), torch.from_numpy(cols),
                       torch.from_numpy(bias), float(thresh), float(gain))
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)


def test_wrappers_reject_wide_rows():
    with pytest.raises(ValueError):
        ck._pad_width(torch.zeros(4, 129))
