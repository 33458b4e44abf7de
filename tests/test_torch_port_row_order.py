"""K1's locality row order (`ops.graph.locality_order` with its PCA
branch, `flash_topk(spatial_sort=...)`, the column-id table of
`sednet::topk`, the encoder's `sort_points`) against the JAX package's
`_locality_order` and the unsorted results, on the CPU's plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.ops.flash_topk import _locality_order
from sednet_tpu_torch.models.sednet import SEDNet
from sednet_tpu_torch.ops.flash_topk import flash_topk, topk_plain
from sednet_tpu_torch.ops.graph import locality_order
from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals


def _spread(rng, n, d):
    """Rows whose covariance has three well separated leading eigenvalues
    (axis scales 8, 4, 2 over a unit rest), rotated at random."""
    x = rng.randn(n, d) * np.r_[8.0, 4.0, 2.0, np.ones(max(d - 3, 0))][:d]
    q, _ = np.linalg.qr(rng.randn(d, d))
    return (x @ q).astype(np.float32)


# The order equals JAX's `_locality_order` where the spectrum is well
# separated (D = 3 takes no PCA): at D > 3 on the port's principal axes
# with each sign set to that of JAX's (LAPACK's eigenvector signs are its
# own; a flipped axis mirrors the curve); on rows with no leading axes
# (isotropic noise) it is still a permutation of 0 .. N-1.
@pytest.mark.parametrize("d", [3, 64, 128])
def test_locality_order_matches_jax(rng, d):
    x = _spread(rng, 500, d)
    want = np.asarray(_locality_order(jnp.asarray(x)))
    xt = torch.from_numpy(x)[None]
    axes = None
    if d > 3:
        c = xt - xt.mean(dim=1, keepdim=True)
        axes = torch.linalg.eigh(c.transpose(1, 2) @ c).eigenvectors[..., -3:]
        cj = jnp.asarray(x) - jnp.mean(jnp.asarray(x), axis=0)
        vj = np.asarray(jnp.linalg.eigh(cj.T @ cj)[1][:, -3:])
        axes = axes * torch.from_numpy(np.sign(
            (vj * axes[0].numpy()).sum(0)).astype(np.float32))
    got = locality_order(xt, axes)[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(torch.sort(locality_order(xt)[0]).values,
                       torch.arange(500, dtype=torch.int32))
    flat = rng.randn(2, 300, d).astype(np.float32)
    perm = locality_order(torch.from_numpy(flat))
    for p in perm:
        assert torch.equal(torch.sort(p).values, torch.arange(300,
                                                              dtype=torch.int32))


def _with_ties(rng, n, d):
    """Rows on a coarse grid, so that many rows lie at exactly equal
    distances from a row (and whole rows repeat)."""
    x = rng.randint(-3, 4, (n, d)).astype(np.float32)
    x[n // 2:n // 2 + 20] = x[:20]
    return x


# Sorted and unsorted give the same indices and distances, ties included
# (each to the lower original index), for the nearest and the farthest,
# both metrics, one shape and a batch, and p other than q.
@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("d,metric", [(3, "sqdist"), (6, "points_normals"),
                                      (40, "sqdist")])
def test_sorted_topk_equals_unsorted(rng, d, metric, largest):
    x = torch.from_numpy(np.stack([_with_ties(rng, 300, d)
                                   for _ in range(2)]))
    k = 16
    for q, p in ((x, x), (x[0], x[0]), (x[:, :200].contiguous(), x)):
        a = flash_topk(q, p, k, metric=metric, largest=largest,
                       spatial_sort=False, return_distances=True)
        b = flash_topk(q, p, k, metric=metric, largest=largest,
                       spatial_sort=True, return_distances=True)
        assert torch.equal(a[0], b[0])
        np.testing.assert_allclose(b[1].numpy(), a[1].numpy(), atol=1e-4)


# The column-id table is the kernel's key: the plain version on columns
# permuted by perm, with perm as the ids, lists the unpermuted answer.
def test_topk_plain_with_col_ids_keys_ties_by_id(rng):
    x = torch.from_numpy(_with_ties(rng, 400, 8))
    perm = torch.from_numpy(rng.permutation(400))
    d0, i0 = topk_plain(x, x, 12)
    d1, i1 = topk_plain(x, x[perm], 12, col_ids=perm.int())
    assert torch.equal(i0, i1)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=1e-5)
    # an op call with the table as the kernel takes it (int32, (B, N))
    i2 = torch.ops.sednet.topk(x[None], x[perm][None], 12, "sqdist", 1.0,
                               False, perm.int()[None])[1]
    assert torch.equal(i2[0], i0)


def test_knn_sorted_equals_unsorted(rng):
    x = torch.from_numpy(rng.randn(2, 256, 64).astype(np.float32))
    assert torch.equal(knn_indices(x, 16, spatial_sort=True),
                       knn_indices(x, 16, spatial_sort=False))


# The encoder in its Morton order equals it without (one permutation at
# entry, one inverse at exit, K1 keyed by the original indices): within
# the float summation order of GroupNorm's statistics, atol 1e-5; with a
# given first-layer graph re-expressed in sorted space, the same.
@pytest.mark.parametrize("factored_gn", [True, False])
def test_encoder_sort_points_equals_unsorted(rng, factored_gn):
    torch.manual_seed(0)
    model = SEDNet(emb_size=16, k=12, factored_gn=factored_gn)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.2)
    x = torch.from_numpy(np.concatenate(
        [rng.randn(2, 300, 3), rng.randn(2, 300, 3)], -1).astype(np.float32))
    idx1 = knn_indices_points_normals(x, 12)
    outs = []
    for sort in (False, True):
        model.encoder.sort_points = sort
        with torch.no_grad():
            outs.append((model(x), model(x, idx1)))
    (a, a1), (b, b1) = outs
    for u, v in ((a, b), (a1, b1), (a, a1)):
        for name in ("embedding", "type_log_prob", "edge_logits"):
            np.testing.assert_allclose(getattr(v, name).numpy(),
                                       getattr(u, name).numpy(), atol=1e-5,
                                       err_msg=name)
