"""The port's model (sednet_tpu_torch.models, weights) against the JAX
package on the CPU, on the same numpy inputs and the committed weights."""
import os

import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.ops.graph import edge_conv_factored as edge_conv_jax
from sednet_tpu.train import build_model, load_params
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.models.backbone import group_norm
from sednet_tpu_torch.ops.graph import edge_conv_factored, gather_neighbors
from sednet_tpu_torch.predict import forward, headline_shapes, load_models
from sednet_tpu_torch.weights import load_npz, params_from_flat

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "bench_10k.npz")


def test_gather_neighbors_clamps_within_shape(rng):
    x = torch.from_numpy(rng.randn(2, 5, 3).astype(np.float32))
    idx = torch.tensor([[[0, 9]] * 5, [[-3, 4]] * 5])
    g = gather_neighbors(x, idx)
    assert torch.equal(g[0, 0, 1], x[0, 4]) and torch.equal(g[1, 0, 0], x[1, 0])


# Same math, different float association (the JAX version runs two
# 2*C_in-wide matmuls against zero/negated halves): atol 1e-5.
@pytest.mark.parametrize("c_in,c_out,neg_scale", [(6, 64, False),
                                                   (64, 128, True)])
def test_edge_conv_factored_matches_jax(rng, c_in, c_out, neg_scale):
    b, n, k = 2, 96, 16
    x = rng.randn(b, n, c_in).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    kernel = (rng.randn(2 * c_in, c_out) / np.sqrt(2 * c_in)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    if neg_scale:
        scale[::3] *= -1.0
    bias = rng.randn(c_out).astype(np.float32)

    dense = nn.Dense(c_out, use_bias=False)
    want = edge_conv_jax(
        jnp.asarray(x), jnp.asarray(idx),
        lambda v: dense.apply({"params": {"kernel": jnp.asarray(kernel)}}, v),
        jnp.asarray(scale), jnp.asarray(bias), groups=2)
    got = edge_conv_factored(
        torch.from_numpy(x), torch.from_numpy(idx).long(),
        torch.from_numpy(kernel.T.copy()), torch.from_numpy(scale),
        torch.from_numpy(bias), groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_group_norm_matches_flax(rng):
    x = rng.randn(2, 50, 32).astype(np.float32) * 3 + 1
    gn = nn.GroupNorm(num_groups=4)
    w = rng.randn(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    want = gn.apply({"params": {"scale": w, "bias": b}}, jnp.asarray(x))
    got = group_norm(torch.from_numpy(x), 4, torch.from_numpy(w),
                     torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("which", ["inst", "type"])
def test_weights_use_every_key(which):
    flat = np.load(CKPT)
    keys = [k for k in flat.files if k.startswith(which + "/")]
    assert len(keys) == 45
    sd = params_from_flat(flat, which)
    assert len(sd) == len(keys)
    model = load_npz(CKPT, which, device="cpu")
    assert set(model.state_dict()) == set(sd)
    # a Dense kernel is transposed into the Linear weight
    np.testing.assert_array_equal(
        model.conv1.weight.detach().numpy(), flat[f"{which}/conv1/kernel"].T)


def test_weights_reject_missing_and_extra_keys():
    flat = dict(np.load(CKPT))
    missing = {k: v for k, v in flat.items() if k != "inst/gn1/scale"}
    model = load_npz(CKPT, "inst", device="cpu")
    with pytest.raises(RuntimeError):
        model.load_state_dict(params_from_flat(missing, "inst"), strict=True)
    extra = {**flat, "inst/extra/bias": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError):
        model.load_state_dict(params_from_flat(extra, "inst"), strict=True)
    with pytest.raises(KeyError):
        params_from_flat({"inst/conv1/weird": np.zeros(2)}, "inst")


@pytest.fixture(scope="module")
def forward_pair():
    """One 512-point eval shape through the JAX model (factored GroupNorm,
    the trained inst weights) and the port, unsorted points."""
    _, x = headline_shapes(1, 512)
    jmodel = build_model(JaxConfig(num_points=512, knn=64, embed=128))
    params = load_params(CKPT)["inst"]
    out = jmodel.apply({"params": params}, jnp.asarray(x))
    model = load_models(CKPT, Config(knn=64, embed=128), device="cpu",
                        which=("inst",))["inst"]
    with torch.no_grad():
        t_out = model(torch.from_numpy(x))
    return out, t_out


# Float association differs through 3 edge convs and 6 GroupNorms; the
# embedding, logits and log-probs agree at atol 1e-4 and the type argmax
# is identical.
def test_sednet_forward_matches_jax(forward_pair):
    out, t_out = forward_pair
    for name in ("embedding", "type_log_prob", "type_logits", "edge_logits"):
        np.testing.assert_allclose(getattr(t_out, name).numpy(),
                                   np.asarray(getattr(out, name)), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(t_out.type_log_prob.argmax(-1).numpy(),
                                  np.asarray(out.type_log_prob).argmax(-1))


def test_forward_returns_unit_embeddings(rng):
    model = load_npz(CKPT, "inst", device="cpu")
    x = torch.from_numpy(headline_shapes(2, 256)[1])
    emb, lp, edge = forward(model, x)
    assert emb.shape == (2, 256, 128) and lp.shape == (2, 256, 6)
    assert edge.shape == (2, 256, 2)
    torch.testing.assert_close(emb.norm(dim=-1), torch.ones(2, 256))


# The normal head (`predict_normal`): JAX's initial parameters with the head,
# written as a flat npz, carried into the port by weights.py; the forward's
# normals_pred (unit rows) at atol 1e-4, as the other heads; the port's
# build_model builds it and the bundle forward returns it under JAX's key.
def test_normal_head_matches_jax(tmp_path):
    import jax

    from sednet_tpu.train import save_params_npz as jax_save_npz
    from sednet_tpu_torch.export import _Forward
    from sednet_tpu_torch.train import build_model as torch_build_model

    _, x = headline_shapes(1, 256)
    jcfg = JaxConfig(num_points=256, knn=16, embed=32, predict_normal=True)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    out = jmodel.apply({"params": params}, jnp.asarray(x))
    path = str(tmp_path / "normal.npz")
    jax_save_npz(path, params)
    model = load_npz(path, "", Config(knn=16, embed=32, predict_normal=True),
                     device="cpu")
    assert {"normal_conv1.weight", "normal_gn.weight",
            "normal_conv2.bias"} <= set(model.state_dict())
    with torch.no_grad():
        t_out = model(torch.from_numpy(x))
        bundle_out = _Forward(model)(torch.from_numpy(x))
    np.testing.assert_allclose(t_out.normals_pred.numpy(),
                               np.asarray(out.normals_pred), atol=1e-4)
    torch.testing.assert_close(t_out.normals_pred.norm(dim=-1),
                               torch.ones(1, 256))
    assert torch.equal(bundle_out["normals_pred"], t_out.normals_pred)
    built = torch_build_model(Config(knn=16, embed=32, predict_normal=True))
    assert set(built.state_dict()) == set(model.state_dict())
