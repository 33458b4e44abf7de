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
from sednet_tpu.ops.fused_edgeconv import \
    fused_edge_reductions as reductions_jax
from sednet_tpu.ops.knn import knn_indices, knn_indices_points_normals
from sednet_tpu.ops.pallas_kernels import (colmax_pallas,
                                           mean_shift_step_pallas,
                                           mean_shift_step_pallas_batched)
from sednet_tpu_torch.ops import _build
from sednet_tpu_torch.ops import cuda_kernels as ck
from sednet_tpu_torch.ops import fused_edgeconv as fe
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


def _mean_shift_step_f64(q, x, bandwidth):
    """One gaussian step in float64: the rows y (R, E) and |o| (R,), o the
    weighted mean before normalisation."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    k = np.exp(np.maximum((q @ x.T - 1.0) / bandwidth ** 2, -75.0))
    o = (k @ x) / k.sum(1, keepdims=True)
    norm = np.linalg.norm(o, axis=1)
    return o / norm[:, None], norm


# The step's exp argument is <= 0 and the output is unit-norm; the plain
# version and the Pallas kernel differ only by summation order (atol 1e-5).
# Each side is first held to the float64 step at the same 1e-5 (measured:
# plain 2.4e-7, Pallas 1.6e-7), so that a failure names the side that
# moved, its row and that row's |o| (a short weighted mean magnifies
# rounding; |o| is down to 0.16 here).
def test_mean_shift_step_plain_matches_pallas(rng):
    x = _unit(rng, 200, 32)
    q = _unit(rng, 200, 32)
    want = mean_shift_step_pallas(jnp.asarray(q), jnp.asarray(x),
                                  jnp.float32(0.4), row_block=64,
                                  col_block=128, interpret=True)
    got = ck.mean_shift_step(torch.from_numpy(q), torch.from_numpy(x), 0.4)
    exact, norm = _mean_shift_step_f64(q, x, 0.4)
    errs = {name: np.abs(np.asarray(side, np.float64) - exact).max(1)
            for name, side in (("plain", got.numpy()),
                               ("pallas", np.asarray(want)))}
    report = {name: (float(e.max()), int(e.argmax()),
                     float(norm[e.argmax()])) for name, e in errs.items()}
    for name, e in errs.items():
        assert e.max() <= 1e-5, f"{name} side moved: (err, row, |o|) " \
            f"{report}"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               err_msg=f"(err, row, |o|) {report}")


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


def _clustered(rng, b, n, e, k=5, noise=0.05):
    """b shapes of n unit rows around k directions (the embeddings'
    shape), as JAX's bf16 test draws them (tests/test_pallas.py)."""
    out = []
    for _ in range(b):
        dirs = _unit(rng, k, e)
        x = dirs[rng.randint(0, k, n)] + noise * rng.randn(n, e)
        out.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    return np.stack(out).astype(np.float32)


# The bf16 branch (`ms_bf16`): the plain version against JAX's Pallas step
# with bf16=True in interpret mode (tests/test_pallas.py:77-82), one shape
# and batched, at widths 12, 16 and 140 and a row count that is no block
# multiple. The roundings are the same (new_x and x to bf16, k summed in
# float32 before its bf16 rounding); the float32 sums run in other orders,
# measured 8e-6 apart at most: atol 3e-5. Each side stays within 3e-5 of
# the same function in float64 on the bf16-rounded inputs, and both differ
# from the float32 step by far more (the branch is taken).
@pytest.mark.parametrize("b,n,e", [(1, 400, 16), (1, 300, 12), (3, 257, 140)])
def test_mean_shift_step_bf16_plain_matches_pallas(rng, b, n, e):
    x = _clustered(rng, b, n, e)
    bw = np.linspace(0.1, 0.3, b).astype(np.float32)
    if b == 1:
        want = np.asarray(mean_shift_step_pallas(
            jnp.asarray(x[0]), jnp.asarray(x[0]), jnp.float32(bw[0]),
            row_block=128, col_block=256, bf16=True, interpret=True))[None]
        got = ck.mean_shift_step(torch.from_numpy(x[0]),
                                 torch.from_numpy(x[0]), float(bw[0]),
                                 bf16=True)[None]
    else:
        want = np.asarray(mean_shift_step_pallas_batched(
            jnp.asarray(x), jnp.asarray(x), jnp.asarray(bw), row_block=128,
            col_block=256, bf16=True, interpret=True))
        got = ck.mean_shift_step_batched(torch.from_numpy(x),
                                         torch.from_numpy(x),
                                         torch.from_numpy(bw), bf16=True)
    inv_b2 = 1.0 / torch.from_numpy(bw) ** 2
    x64 = torch.from_numpy(x).double()
    exact = ck.mean_shift_step_plain(x64, x64, inv_b2.double(),
                                     bf16=True).numpy()
    f32 = ck.mean_shift_step_plain(torch.from_numpy(x), torch.from_numpy(x),
                                   inv_b2).numpy()
    errs = {"plain": float(np.abs(got.numpy() - exact).max()),
            "pallas": float(np.abs(want - exact).max())}
    assert max(errs.values()) <= 3e-5, errs
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    assert np.abs(got.numpy() - f32).max() > 1e-4


# The bf16 kernel runs the 140-d enriched embedding at 144 (a multiple of
# 16, wgmma's depth), the loops padding it once: the plain bf16 step on x
# zero-padded from 140 to 144 is JAX's Pallas bf16 step at 140 (interpret
# mode), within the atol of the test above, with the padding columns zero.
@pytest.mark.parametrize("b", [1, 2])
def test_mean_shift_step_bf16_plain_at_144_matches_pallas_at_140(rng, b):
    x = _clustered(rng, b, 257, 140)
    bw = np.linspace(0.15, 0.25, b).astype(np.float32)
    want = np.asarray(mean_shift_step_pallas_batched(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(bw), row_block=128,
        col_block=256, bf16=True, interpret=True))
    xp = _build.pad_width(torch.from_numpy(x), _build.BF16_WIDTH_STEP)
    assert xp.shape == (b, 257, 144)
    got = ck.mean_shift_step_batched(xp, xp, torch.from_numpy(bw),
                                     bf16=True).numpy()
    assert not got[..., 140:].any()
    np.testing.assert_allclose(got[..., :140], want, atol=3e-5)


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
    # the kernels take rows up to 256 wide, as the TPU kernels take any
    # width; narrower rows are zero-padded to a multiple of 32
    with pytest.raises(ValueError):
        _build.pad_width(torch.zeros(4, 257))
    x = torch.ones(4, 140)
    padded = _build.pad_width(x)
    assert padded.shape == (4, 160) and padded.is_contiguous()
    assert torch.equal(padded[:, :140], x) and not padded[:, 140:].any()
    assert _build.pad_width(torch.zeros(4, 128)).shape == (4, 128)


def test_pad_width_bf16_step():
    # the bf16 mean-shift step takes multiples of 16: 140 -> 144, 12 -> 16,
    # 128 as it is; the float32 kernels' step stays 32 (140 -> 160)
    x = torch.ones(3, 140)
    padded = _build.pad_width(x, _build.BF16_WIDTH_STEP)
    assert padded.shape == (3, 144) and padded.is_contiguous()
    assert torch.equal(padded[:, :140], x) and not padded[:, 140:].any()
    assert _build.pad_width(torch.ones(3, 12), 16).shape == (3, 16)
    y = torch.ones(3, 128)
    assert _build.pad_width(y, 16) is y
    assert _build.pad_width(x).shape == (3, 160)
    with pytest.raises(ValueError):
        _build.pad_width(torch.zeros(3, 257), 16)
    assert ck.kernel_width(x, bf16=True) is x   # a CPU tensor as it is


def test_kernel_width_pads_only_for_the_card():
    # a CPU tensor goes to the plain versions as it is; the main path's
    # loops pad a CUDA tensor once (see test_torch_port_cuda.py)
    x = torch.ones(2, 8, 140)
    assert ck.kernel_width(x) is x


def _tf32(a):
    """a rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the card's cvt.rna.tf32.f32 does: add half of the 13 dropped
    bits' range to the magnitude, then clear them."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(a, b, terms=3):
    """a @ b as the tensor-core kernels take it (csrc/sim_tile.cuh): each
    operand split into hi = tf32(a) and lo = tf32(a - hi); lo.hi + hi.lo,
    then hi.hi, each product of TF32 values exact in float32."""
    ahi, bhi = _tf32(a), _tf32(b)
    if terms == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def _split_step(q, x, inv_b2, terms=3):
    """One mean-shift step (B, N, E) with both products by the split."""
    s = _split_mm(q, x.transpose(1, 2), terms)
    k = torch.exp(torch.clamp_min((s - 1.0) * inv_b2[:, None, None], -75.0))
    o = _split_mm(k, x, terms) / torch.clamp_min(k.sum(-1, keepdim=True),
                                                 1e-30)
    return o / torch.sqrt(torch.clamp_min((o * o).sum(-1, keepdim=True),
                                          1e-24))


def test_tf32_rounding_emulation():
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -9), 3.0])
    assert torch.equal(_tf32(a), want)
    x = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(
        np.float32))
    hi = _tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


# The numerics of the tensor-core design of K2/K2b and K3, on the CPU
# before any card run: one mean-shift step with both products by the
# three-term TF32 split, on clustered unit rows of the enriched width, is
# held to JAX's Pallas step (interpret mode) at 1e-5 at each bandwidth; a
# single TF32 pass is not. The same split's K3 scores are held to the plain
# scores at 1e-5.
def test_tf32_split_step_matches_pallas(rng):
    n, e = 512, 140
    centres = _unit(rng, 3, 8, e)
    lab = rng.randint(0, 8, (3, n))
    x = np.take_along_axis(centres, lab[..., None], 1)
    x = x + (0.1 / np.sqrt(e)) * rng.randn(3, n, e).astype(np.float32)
    x = (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    bw = np.array([0.05, 0.15, 0.3], np.float32)
    want = np.asarray(mean_shift_step_pallas_batched(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(bw), interpret=True))
    t = torch.from_numpy(x)
    inv_b2 = 1.0 / torch.from_numpy(bw) ** 2
    got = _split_step(t, t, inv_b2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    one_pass = _split_step(t, t, inv_b2, terms=1).numpy()
    assert np.abs(one_pass - want).max() > 1e-5

    rows, cols = t[0], _split_step(t, t, inv_b2)[0]
    plain = rows @ cols.T
    np.testing.assert_allclose(_split_mm(rows, cols.T).numpy(),
                               plain.numpy(), atol=1e-5, rtol=0)
    bias = torch.from_numpy(rng.randint(0, 5, n).astype(np.float32))
    best_split = (_split_mm(rows, cols.T) + bias).max(1).values
    best_plain, _ = ck.colmax_plain(rows, cols, bias, float("inf"), 1.0)
    np.testing.assert_allclose(best_split.numpy(), best_plain.numpy(),
                               atol=1e-5, rtol=0)


def _fmaf_norms(x):
    """Squared row norms as the kernel sums them: four partial sums over the
    channels c = 0, 1, 2, 3 mod 4, each ascending with a fused multiply-add
    (each step rounded once to float32), then (s0 + s1) + (s2 + s3)."""
    x64 = x.double()
    parts = []
    for c in range(4):
        acc = torch.zeros(x.shape[0], dtype=torch.float32)
        for e in range(c, x.shape[1], 4):
            acc = (x64[:, e] * x64[:, e] + acc.double()).float()
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _split_topk(q, p, k, terms=3):
    """K1's tensor-core distance tile emulated on the CPU: q.p by the
    three-term TF32 split (`_split_mm`), the f32 norms in its order,
    d = (|q|^2 + |p|^2) - 2 q.p, then the k smallest by (value, column)."""
    s = _split_mm(q, p.T, terms)
    d = (_fmaf_norms(q)[:, None] + _fmaf_norms(p)[None, :]) - 2.0 * s
    vals, order = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], order[:, :k]


# The numerics of K1's tensor-core tile, on the CPU before any card run:
# neighbour sets from the split distances equal JAX's Pallas top-k outside
# near-ties (compare_with_plain's rule) and distances within its tolerance,
# on layer-2-like rows (d = 64, k = 64) and on unit rows of the enriched
# width 140 zero-padded to 160 (k = 128, the bandwidth call); a single
# TF32 pass breaks that tolerance.
@pytest.mark.parametrize("d,pad,k", [(64, 64, 64), (140, 160, 128)])
def test_tf32_split_topk_matches_topk_pallas(rng, d, pad, k):
    n = 300
    x = (_unit(rng, n, d) if d == 140 else
         rng.randn(n, d).astype(np.float32))
    idx_j, dist_j = topk_pallas(jnp.asarray(x), jnp.asarray(x), k,
                                return_distances=True, interpret=True,
                                spatial_sort=False, col_halves=1)
    idx_j, dist_j = np.asarray(idx_j), np.asarray(dist_j)
    t = torch.from_numpy(x)
    tp = torch.nn.functional.pad(t, (0, pad - d))
    dist, idx = _split_topk(tp, tp, k)
    cmp = compare_with_plain(t, t, k, idx, dist)
    assert cmp["bad_rows"] == 0, cmp
    assert max(cmp["max_abs_err"], cmp["nbr_err"]) <= cmp["tol"], cmp
    dp, _ = topk_plain(t, t, k + 1)
    near_tie = ((dp[:, k] - dp[:, k - 1]).abs() <= 1e-6 * (cmp["tol"] / 1e-5)
                ).numpy()
    same = np.array([set(a) == set(b) for a, b in zip(idx.tolist(),
                                                       idx_j.tolist())])
    assert (same | near_tie).all()
    assert np.abs(dist.numpy() - dist_j).max() <= cmp["tol"]
    one_pass, _ = _split_topk(tp, tp, k, terms=1)
    assert np.abs(one_pass.numpy() - dist_j).max() > cmp["tol"]


def _split_fused(geom, a, k):
    """K4's route at D > 8 emulated on the CPU: the distances of K1's
    tensor-core tile (`_split_mm`, norms in the kernel's order), each row's
    list of its k best columns by (value, column), T its k-th value, the
    tie flag from the (k+1)-th value, the reductions over the list, then,
    on flagged rows, the columns past the list's last one at d == T.
    Returns ((mx, sm, sq, cnt), flag)."""
    d = ((_fmaf_norms(geom)[:, None] + _fmaf_norms(geom)[None, :])
         - 2.0 * _split_mm(geom, geom.T))
    vals, order = torch.sort(d, dim=1, stable=True)
    t = vals[:, k - 1]
    flag = vals[:, k] == t
    cols = order[:, :k]
    g = a[cols]
    cols_of = torch.arange(d.shape[1])[None, :]
    extra = ((d == t[:, None]) & (cols_of > cols[:, -1:])
             & flag[:, None]).to(a.dtype)
    neg = torch.tensor(float("-inf"))
    mx = torch.maximum(g.amax(1), torch.where(
        extra.bool()[..., None], a[None], neg).amax(1))
    out = (mx, g.sum(1) + extra @ a, (g * g).sum(1) + extra @ (a * a),
           k + extra.sum(1))
    return out, flag


def _agree_outside_near_ties(geom, a, k, out, want):
    """compare_with_plain's rule between two results: outside the rows
    whose plain k-th and (k+1)-th distances lie within 1e-6 of the
    rounding scale 1 + max|q|^2, counts and maxima equal and sums within
    1e-5 * k * max|a| (and max|a|^2)."""
    dp, _ = topk_plain(geom, geom, k + 1)
    scale = 1.0 + float((geom * geom).sum(-1).max())
    firm = ((dp[:, k] - dp[:, k - 1]).abs() > 1e-6 * scale).numpy()
    amax = float(a.abs().max())
    mx, sm, sq, cnt = (np.asarray(o)[firm] for o in out)
    wmx, wsm, wsq, wcnt = (np.asarray(w)[firm] for w in want)
    np.testing.assert_array_equal(cnt, wcnt)
    np.testing.assert_array_equal(mx, wmx)
    np.testing.assert_allclose(sm, wsm, rtol=0, atol=1e-5 * k * amax)
    np.testing.assert_allclose(sq, wsq, rtol=0, atol=1e-5 * k * amax ** 2)
    return int(firm.sum())


# The numerics of K4's route on the CPU, before any card run: the split
# distances of K1's tile, T, the tie flag and the reductions over the list
# and the tied columns agree with JAX's Pallas kernel (interpret mode) on
# every row outside a near-tie at the k-th distance, by compare_with_plain's
# rule and tolerance (1e-6 of the rounding scale for a near-tie; sums within
# 1e-5 * k * max|a|, the reassociation bound of about k terms), at a
# layer-2-like width; random rows leave no tie flagged.
def test_fused_route_emulation_matches_pallas(rng):
    n, d, c, k = 256, 64, 64, 16
    geom = rng.randn(n, d).astype(np.float32)
    a = rng.randn(n, c).astype(np.float32)
    want = reductions_jax(jnp.asarray(geom), jnp.asarray(a), k,
                          interpret=True)
    gt, at = torch.from_numpy(geom), torch.from_numpy(a)
    out, flag = _split_fused(gt, at, k)
    assert not flag.any()
    assert _agree_outside_near_ties(gt, at, k, out, want) >= n - 2
    cmp = fe.compare_with_plain(gt[None], at[None], k,
                                tuple(o[None] for o in out))
    assert cmp["bad_rows"] == 0, cmp


# On an integer grid every distance is an exact integer in float32, under
# the split as under any summation order: ties at the k-th distance are
# real, the flag is set on exactly the rows whose set exceeds k, and the
# result equals JAX's on every row.
def test_fused_route_emulation_flags_exactly_the_tied_rows(rng):
    n, d, c, k = 256, 16, 32, 16
    geom = rng.randint(-2, 3, (n, d)).astype(np.float32)
    a = rng.randn(n, c).astype(np.float32)
    want = [np.asarray(w) for w in reductions_jax(
        jnp.asarray(geom), jnp.asarray(a), k, interpret=True)]
    gt, at = torch.from_numpy(geom), torch.from_numpy(a)
    out, flag = _split_fused(gt, at, k)
    pcnt = fe.fused_edge_reductions_plain(gt, at, k)[3]
    np.testing.assert_array_equal(flag.numpy(), (pcnt > k).numpy())
    assert 0 < int(flag.sum()) < n
    np.testing.assert_array_equal(out[3].numpy(), want[3])
    np.testing.assert_array_equal(out[0].numpy(), want[0])
    amax = float(np.abs(a).max())
    np.testing.assert_allclose(out[1].numpy(), want[1], rtol=0,
                               atol=1e-5 * float(want[3].max()) * amax)
    np.testing.assert_allclose(out[2].numpy(), want[2], rtol=0,
                               atol=1e-5 * float(want[3].max()) * amax ** 2)


def _rule_inputs(seed=0, b=2, n=700, e=32):
    rng = np.random.RandomState(seed)
    c = rng.randn(b, 6, e)
    lab = rng.randint(0, 6, (b, n))
    x = np.stack([c[i][lab[i]] for i in range(b)]) + 0.05 * rng.randn(b, n, e)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return (torch.tensor(x, dtype=torch.float32),
            1.0 / torch.tensor([0.15, 0.2][:b]) ** 2)


# The bf16 step's float64 rule (`ops.bf16_rule.check_bf16_step`), on the
# CPU: the plain version at two row blocks passes; a row that rounds one
# held-apart weight to its other bf16 neighbour passes, that weight named;
# the same row moved by as much in a direction no weight explains fails,
# with the factor 2 unchanged.
def test_bf16_rule_plain_passes():
    from sednet_tpu_torch.ops.bf16_rule import check_bf16_step

    x, inv = _rule_inputs()
    plain = ck.mean_shift_step_plain(x, x, inv, bf16=True)
    other = ck.mean_shift_step_plain(x, x, inv, row_block=64, bf16=True)
    rec = check_bf16_step("plain", other, plain, x, inv)
    assert rec["rows_failed"] == 0 and rec["held_apart"] > 0
    assert rec["f64_err"] <= rec["bound"] == 2.0 * rec["plain_f64_err"]


def test_bf16_rule_holds_apart_a_rounding_and_catches_the_rest():
    from sednet_tpu_torch.ops.bf16_rule import bf16_neighbours, check_bf16_step

    x, inv = _rule_inputs()
    # a reference far better than float32's sums (the float64 function
    # rounded once), so that one weight's rounding stands out of the bound
    plain = ck.mean_shift_step_plain(x.double(), x.double(), inv.double(),
                                     bf16=True).float()
    xb = x[0].to(torch.bfloat16).double()
    s = xb @ xb.T
    k = torch.exp(torch.clamp_min((s - 1.0) * float(inv[0]), -75.0))
    kb, nb = bf16_neighbours(k)
    # of the weights within a hundredth of a bf16 step of their midpoint,
    # the one whose rounding moves its row most
    near = (k - 0.5 * (kb + nb)).abs() < 1e-2 * (nb - kb).abs()
    reach = torch.where(near, (nb - kb).abs() / k.sum(1, keepdim=True), 0.0)
    i, c = divmod(int(reach.argmax()), k.shape[1])
    assert float(reach[i, c]) > 0.0

    def row_with(weights):
        o = (weights[i] @ xb) / k[i].sum()
        return (o / o.norm()).float()

    flipped = kb.clone()
    flipped[i, c] = nb[i, c]
    got = plain.clone()
    got[0, i] = row_with(flipped)
    rec = check_bf16_step("flip", got, plain, x, inv)
    assert rec["rows_fitted"] >= 1 and [0, i, c] in rec["held_named"]
    # the same size of error in a direction no weight gives
    moved = row_with(kb).double()
    delta = (got[0, i].double() - moved).norm()
    bad = plain.clone()
    bad[0, i] = (moved + delta * torch.roll(moved, 1) / moved.norm()).float()
    rec = check_bf16_step("bad", bad, plain, x, inv, raise_on_fail=False)
    assert rec["rows_failed"] == 1 and rec["failed_named"][0]["at"] == [0, i]
    with pytest.raises(AssertionError):
        check_bf16_step("bad", bad, plain, x, inv)
