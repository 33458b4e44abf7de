"""The port's pointnet2 family (sednet_tpu_torch.ops.pointnet2) against
`sednet_tpu/ops/pointnet2.py` on the CPU, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.ops import pointnet2 as J
from sednet_tpu_torch.ops import pointnet2 as T


def _cloud(rng, b, n):
    return rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)


# FPS: a discrete choice a step; the port's distances x, y, z in order,
# JAX's a sum of three, the same bits on these clouds: equal indices
def test_furthest_point_sampling_matches_jax(rng):
    pts = _cloud(rng, 2, 500)
    want = np.asarray(J.furthest_point_sampling(jnp.asarray(pts), 64))
    got = T.furthest_point_sampling(torch.from_numpy(pts), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0].eq(0).all()


def test_gather_and_group_points_match_jax(rng):
    feats = rng.randn(2, 40, 5).astype(np.float32)
    idx = rng.randint(0, 40, (2, 7)).astype(np.int32)
    idx3 = rng.randint(0, 40, (2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        T.gather_operation(torch.from_numpy(feats),
                           torch.from_numpy(idx).long()).numpy(),
        np.asarray(J.gather_operation(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        T.group_points(torch.from_numpy(feats),
                       torch.from_numpy(idx3).long()).numpy(),
        np.asarray(J.group_points(jnp.asarray(feats), jnp.asarray(idx3))))


# three_nn: the port's plain top-k (|q|^2 + |p|^2 - 2 q.p) against JAX's
# XLA path ((|q|^2 - 2 q.p) + |p|^2): the same neighbours outside near-ties
# (none in these clouds: the 3rd and 4th distances lie more than 1e-6
# apart, ten times their float32 rounding, which is asserted), distances at
# atol 1e-5
def test_three_nn_matches_jax(rng):
    unknown, known = _cloud(rng, 2, 300), _cloud(rng, 2, 200)
    dj, ij = (np.asarray(v) for v in J.three_nn(jnp.asarray(unknown),
                                                jnp.asarray(known)))
    d, i = T.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    full = np.sort(((unknown[:, :, None] - known[:, None]) ** 2).sum(-1), -1)
    assert (full[..., 3] - full[..., 2]).min() > 1e-6
    np.testing.assert_array_equal(i.numpy(), ij)
    np.testing.assert_allclose(d.numpy(), dj, atol=1e-5)


# three_interpolate: forward at atol 1e-6 (sums of three products) and the
# gradients of a weighted sum against jax.grad at atol 1e-5
def test_three_interpolate_and_gradient_match_jax(rng):
    feats = rng.randn(2, 30, 4).astype(np.float32)
    idx = rng.randint(0, 30, (2, 50, 3)).astype(np.int32)
    dist = rng.uniform(0.01, 1.0, (2, 50, 3)).astype(np.float32)
    cot = rng.randn(2, 50, 4).astype(np.float32)
    w_j = J.interpolation_weights(jnp.asarray(dist))
    w_t = T.interpolation_weights(torch.from_numpy(dist))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)

    def loss_j(f, w):
        return jnp.sum(J.three_interpolate(f, jnp.asarray(idx), w) * cot)

    out_j = J.three_interpolate(jnp.asarray(feats), jnp.asarray(idx), w_j)
    gf_j, gw_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(feats), w_j)
    f_t = torch.from_numpy(feats).requires_grad_()
    wt = w_t.clone().requires_grad_()
    out_t = T.three_interpolate(f_t, torch.from_numpy(idx).long(), wt)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-6)
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(gf_j), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=1e-5)


# ball_query: JAX's rule (the first n_sample hits in index order, empty
# slots repeat the first hit, the count clipped, a center with no hit all
# zeros); no squared distance lies within 1e-6 of radius^2 (asserted), so
# the two float32 associations agree on every radius test: equal arrays
@pytest.mark.parametrize("radius,n_sample", [(0.2, 8), (0.35, 32)])
def test_ball_query_matches_jax(rng, radius, n_sample):
    points = _cloud(rng, 2, 200)
    centers = np.concatenate([points[:, :20], np.full((2, 1, 3), 9.0,
                                                      np.float32)], 1)
    d = ((centers[:, :, None] - points[:, None]) ** 2).sum(-1)
    assert np.abs(d - radius * radius).min() > 1e-6
    ij, cj = J.ball_query(jnp.asarray(centers), jnp.asarray(points),
                          radius=radius, n_sample=n_sample)
    it, ct = T.ball_query(torch.from_numpy(centers),
                          torch.from_numpy(points), radius=radius,
                          n_sample=n_sample)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct[:, -1].eq(0).all() and it[:, -1].eq(0).all()
