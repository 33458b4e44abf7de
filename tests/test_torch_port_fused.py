"""The port's fused edge convolution (sednet_tpu_torch.ops.fused_edgeconv,
kernel K4's plain version on the CPU) against the JAX package's, whose
Pallas kernel runs in interpret mode, on the same numpy inputs."""
import os

import flax.traverse_util
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.models.backbone import DGCNNEncoder as JaxEncoder
from sednet_tpu.ops.fused_edgeconv import encoder_apply_fused as enc_fused_jax
from sednet_tpu.ops.fused_edgeconv import fused_edge_conv as conv_fused_jax
from sednet_tpu.ops.fused_edgeconv import \
    fused_edge_reductions as reductions_jax
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.models import apply_fused
from sednet_tpu_torch.models.backbone import DGCNNEncoder
from sednet_tpu_torch.ops.fused_edgeconv import (encoder_apply_fused,
                                                 fused_edge_conv,
                                                 fused_edge_reductions)
from sednet_tpu_torch.ops.graph import edge_conv_factored
from sednet_tpu_torch.ops.knn import knn_indices
from sednet_tpu_torch.predict import headline_shapes, load_models
from sednet_tpu_torch.weights import params_from_flat

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "bench_10k.npz")


def _points_normals(rng, *shape):
    x = rng.standard_normal((*shape, 6)).astype(np.float32)
    x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    return x


def _reductions_both(geom, a, k, metric):
    want = reductions_jax(jnp.asarray(geom), jnp.asarray(a), k,
                          metric=metric, interpret=True)
    got = fused_edge_reductions(torch.from_numpy(geom), torch.from_numpy(a),
                                k, metric=metric)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


# Random inputs have no near-ties at the k-th distance, so the neighbour
# sets and counts are equal and the max is the same element; sums of ~k
# products of unit-scale values agree to float32 reassociation (1e-4).
@pytest.mark.parametrize("metric,d,c", [("sqdist", 16, 32),
                                        ("points_normals", 6, 64)])
def test_fused_reductions_plain_matches_jax(metric, d, c):
    rng = np.random.default_rng(0)
    geom = (_points_normals(rng, 256) if metric == "points_normals"
            else rng.standard_normal((256, d)).astype(np.float32))
    a = rng.standard_normal((256, c)).astype(np.float32)
    (wmx, wsm, wsq, wcnt), (mx, sm, sq, cnt) = _reductions_both(
        geom, a, 16, metric)
    np.testing.assert_array_equal(cnt, wcnt)
    assert cnt.min() == 16
    np.testing.assert_array_equal(mx, wmx)
    np.testing.assert_allclose(sm, wsm, atol=1e-4)
    np.testing.assert_allclose(sq, wsq, atol=1e-4)


def test_fused_reductions_plain_counts_every_tie():
    # integer coordinates: every distance is an exact integer in float32
    # under any summation order, so ties at the k-th distance are exact in
    # both packages and all of them join the set (count > k)
    rng = np.random.default_rng(7)
    geom = rng.integers(-3, 4, (240, 3)).astype(np.float32)
    a = rng.standard_normal((240, 8)).astype(np.float32)
    (wmx, wsm, wsq, wcnt), (mx, sm, sq, cnt) = _reductions_both(
        geom, a, 6, "sqdist")
    np.testing.assert_array_equal(cnt, wcnt)
    assert cnt.max() > 6
    np.testing.assert_array_equal(mx, wmx)
    np.testing.assert_allclose(sm, wsm, atol=1e-4)
    np.testing.assert_allclose(sq, wsq, atol=1e-4)


def test_fused_edge_conv_negative_scale_matches_jax_and_factored():
    # half the GroupNorm scales negative: those channels need the min of
    # the pre-activation, which the sign trick turns into a max
    rng = np.random.default_rng(2)
    n, c_in, c_out, k = 200, 3, 16, 8
    x = rng.standard_normal((n, c_in)).astype(np.float32)
    kernel = (rng.standard_normal((2 * c_in, c_out)) / 2).astype(np.float32)
    scale = (rng.choice([-1.0, 1.0], c_out)
             * (0.5 + rng.random(c_out))).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    want = conv_fused_jax(jnp.asarray(x), jnp.asarray(x), jnp.asarray(kernel),
                          jnp.asarray(scale), jnp.asarray(bias), k, groups=2,
                          interpret=True)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(kernel.T.copy())
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    got = fused_edge_conv(xt, xt, wt, st, bt, k, groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the index path (K1 graph + gather) on the same layer: no ties, so
    # the count is N*K and the two agree to reassociation
    ref = edge_conv_factored(xt[None], knn_indices(xt[None], k), wt, st, bt,
                             groups=2)[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def test_encoder_apply_fused_matches_jax_and_index_path():
    rng = np.random.default_rng(3)
    x = _points_normals(rng, 2, 256)
    enc_j = JaxEncoder(mode=5, k=16)
    params = enc_j.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    gj, fj = enc_fused_jax(params, jnp.asarray(x), mode=5, k=16,
                           interpret=True)
    flat = {"enc/" + k: np.array(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}
    enc = DGCNNEncoder(mode=5, k=16)
    enc.load_state_dict(params_from_flat(flat, "enc"), strict=True)
    xt = torch.from_numpy(x)
    g, f = encoder_apply_fused(enc, xt)
    # float association differs through 3 layers and 4 GroupNorms
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-4)
    with torch.no_grad():
        g_idx, f_idx = enc(xt)
    np.testing.assert_allclose(f.numpy(), f_idx.numpy(), atol=1e-4)
    np.testing.assert_allclose(g.numpy(), g_idx.numpy(), atol=1e-4)


def test_apply_fused_matches_index_forward_on_trained_weights():
    _, x = headline_shapes(2, 384)
    model = load_models(CKPT, Config(knn=16), device="cpu",
                        which=("inst",))["inst"]
    xt = torch.from_numpy(x)
    before = fused_edge_reductions.launches
    with torch.no_grad():
        fused = apply_fused(model, xt)
        ref = model(xt)
    assert fused_edge_reductions.launches == before  # CPU: plain version
    for name in ("embedding", "type_log_prob", "edge_logits"):
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(ref, name).numpy(), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(fused.type_log_prob.argmax(-1).numpy(),
                                  ref.type_log_prob.argmax(-1).numpy())
