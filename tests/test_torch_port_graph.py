"""The port's gather-reduce (kernel K6's plain version,
sednet_tpu_torch.ops.graph) against the JAX package's gather and
reductions on the CPU, and the edge convolution that goes through it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.ops.graph import gather_neighbors as gather_jax
from sednet_tpu_torch.ops.graph import (edge_conv_factored, gather_reduce,
                                        gather_reduce_plain)

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
