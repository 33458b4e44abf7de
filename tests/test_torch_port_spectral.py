"""The port's spectral enrichment (sednet_tpu_torch.cluster.spectral and
its LOBPCG) against the JAX package on the CPU. The LOBPCG start block is
JAX's own `jax.random.normal(key, (n, k))`, handed to the port, so both
solvers take the same path; eigenvector columns are compared up to sign."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import lobpcg_standard as lobpcg_jax

from sednet_tpu.cluster.spectral import compute_entropy as entropy_jax
from sednet_tpu.cluster.spectral import hpnet_enrich_dense as enrich_jax
from sednet_tpu.cluster.spectral import hpnet_process as hpnet_jax
from sednet_tpu.cluster.spectral import \
    normal_affinity_topk as affinity_jax
from sednet_tpu.cluster.spectral import spectral_eigvecs as spectral_eigvecs_jax
from sednet_tpu_torch.cluster.lobpcg import lobpcg_standard
from sednet_tpu_torch.cluster.spectral import (compute_entropy,
                                               hpnet_enrich_dense,
                                               hpnet_process,
                                               normal_affinity_topk,
                                               spectral_eigvecs_matfree)
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.predict import SpectralCache, spectral_embed

N = 300


def _cloud(seed, n=N):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, nrm


def _x0(key, n, k=12):
    return np.array(jax.random.normal(key, (n, k), jnp.float32))


def _align_signs(got, want):
    """Flip each column of got to the sign of want's (sign is free)."""
    s = np.sign((got * want).sum(0))
    return got * np.where(s == 0, 1.0, s)


@pytest.fixture(scope="module")
def affinity_pair():
    xyz, nrm = _cloud(0)
    want = np.asarray(affinity_jax(jnp.asarray(xyz), jnp.asarray(nrm),
                                   sigma=0.1, k=50))
    got = normal_affinity_topk(torch.from_numpy(xyz), torch.from_numpy(nrm),
                               sigma=0.1, k=50).numpy()
    return got, want


# The k FARTHEST neighbours (the reference's quirk) give the same sets in
# both packages; entries differ only in the order their terms are summed.
# A weight that underflows to ~1e-41 (opposite normals) cancels against
# the 1e-12 fill in both packages and leaves a rounding residue whose bits
# follow that order, so entries are held at rtol 1e-5 plus 1e-6 of the
# largest entry.
def test_normal_affinity_topk_matches_jax(affinity_pair):
    got, want = affinity_pair
    assert got.dtype == np.float32 and got.shape == (N, N)
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())


def test_compute_entropy_matches_jax():
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((700, 12)).astype(np.float32)
    feat[:, 3] = 0.5  # a constant channel (range 0)
    want = float(entropy_jax(jnp.asarray(feat), row_block=256))
    got = float(compute_entropy(torch.from_numpy(feat), row_block=256))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# 10 iterations do not converge, so the result depends on every step;
# with the same start block the solvers stay within float32 rounding of
# each other, amplified in the last, least converged columns and in pairs
# of close eigenvalues (measured at most 9.7e-4 here), so eigenvectors are
# held per column up to sign at 2e-3, the leading six at 1e-4.
def test_lobpcg_matches_jax_up_to_column_sign(affinity_pair):
    _, aff = affinity_pair
    x0 = _x0(jax.random.PRNGKey(3), N)
    theta_j, u_j, it_j = lobpcg_jax(jnp.asarray(aff), jnp.asarray(x0), m=10)
    theta, u, it = lobpcg_standard(torch.from_numpy(aff.copy()),
                                   torch.from_numpy(x0), m=10)
    assert it == int(it_j) == 10
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_j), rtol=1e-5)
    u, u_j = _align_signs(u.numpy(), np.asarray(u_j)), np.asarray(u_j)
    np.testing.assert_allclose(u, u_j, atol=2e-3)
    np.testing.assert_allclose(u[:, [0, 3, 4, 5, 6, 7]],
                               u_j[:, [0, 3, 4, 5, 6, 7]], atol=1e-4)


def test_hpnet_process_matches_jax():
    xyz, nrm = _cloud(4)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((N, 16)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(6), N)).astype(np.float32)
    edge = rng.standard_normal((N, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    args_j = [jnp.asarray(a) for a in (emb, xyz, nrm)]
    args_t = [torch.from_numpy(a) for a in (emb, xyz, nrm)]
    extra_j = {"type_log_prob": jnp.asarray(lp),
               "edge_logits": jnp.asarray(edge)}
    extra_t = {"type_log_prob": torch.from_numpy(lp),
               "edge_logits": torch.from_numpy(edge)}
    # the same eigenvectors (JAX's) in both: the weighting and concat agree
    # to float32 rounding
    v = spectral_eigvecs_jax(affinity_jax(args_j[1], args_j[2]), key)
    want = np.asarray(hpnet_jax(*args_j, cached_eigvecs=v, **extra_j))
    got = hpnet_process(*args_t, cached_eigvecs=torch.from_numpy(
        np.array(v)), **extra_t).numpy()
    assert got.shape == want.shape == (N, 16 + 12 + 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the whole path from the same start block: every eigenvector row is
    # unit, so each row of the middle block has the norm |weight| =
    # |0.5 - entropy(v)|, free of column signs. That entropy reads
    # per-channel ranges of the row-normalised eigenvectors, which rows of
    # raw norm ~1e-6 set, so float32 rounding of the solve moves it by a
    # few 1e-3 (measured 3.2e-3 here): held at 1e-2
    want = np.asarray(hpnet_jax(*args_j, key=key, **extra_j))
    got = hpnet_process(*args_t, x0=_x0(key, N), **extra_t).numpy()
    for lo, hi in ((0, 16), (28, 36)):
        np.testing.assert_allclose(got[:, lo:hi], want[:, lo:hi], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[:, 16:28], axis=1),
                               np.linalg.norm(want[:, 16:28], axis=1),
                               atol=1e-2)


def test_hpnet_enrich_dense_matches_jax():
    xyz, nrm = _cloud(7)
    emb = np.random.default_rng(8).standard_normal((N, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(enrich_jax(jnp.asarray(emb), jnp.asarray(xyz),
                                 jnp.asarray(nrm), key))
    got = hpnet_enrich_dense(torch.from_numpy(emb), torch.from_numpy(xyz),
                             torch.from_numpy(nrm), x0=_x0(key, N)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # the embedding's share of each unit row depends on the two entropy
    # weights, not on eigenvector signs; the eigenvectors' entropy carries
    # the solve's rounding (see test_hpnet_process_matches_jax)
    np.testing.assert_allclose(np.linalg.norm(got[:, :16], axis=1),
                               np.linalg.norm(want[:, :16], axis=1),
                               rtol=1e-3)


def test_spectral_embed_caches_and_refuses_matfree(tmp_path):
    xyz, nrm = (torch.from_numpy(a) for a in _cloud(10, 128))
    x0 = torch.from_numpy(_x0(jax.random.PRNGKey(0), 128))
    cache = SpectralCache(str(tmp_path), 0.1, 50)
    v, ent = spectral_embed(xyz, nrm, Config(), shape_id="s0", cache=cache,
                            x0=x0)
    assert v.shape == (128, 12) and cache.get("s0") is not None
    v2, ent2 = spectral_embed(xyz, nrm, Config(), shape_id="s0",
                              cache=cache, x0=x0 + 1.0)
    assert torch.equal(v, v2) and torch.equal(ent, ent2)
    # above the dense cap, or asked for, the matrix-free solver (default
    # layout "scatter") from the same start block
    want = spectral_eigvecs_matfree(xyz, nrm, x0)
    for cfg in (Config(spectral_dense_max_n=100),
                Config(spectral_matfree=True)):
        v3, ent3 = spectral_embed(xyz, nrm, cfg, x0=x0)
        assert torch.equal(v3, want) and not torch.equal(v3, v)
        assert torch.equal(ent3, compute_entropy(want))
