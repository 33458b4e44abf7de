"""The direct GroupNorm edge convolution (`factored_gn=False`) and bf16
model compute (`model_bf16=True`) of the port against the JAX package's on
the CPU: the same numpy inputs, the port's model carrying JAX's init
parameters, at N = 256, k = 16, embed = 32."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu import train as jtrain
from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.losses import TripletConfig as JaxTripletConfig
from sednet_tpu.ops.knn import knn_indices as jknn
from sednet_tpu.ops.knn import knn_indices_points_normals as jknn_pn
from sednet_tpu_torch import train as ttrain
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.models.backbone import EdgeConv
from sednet_tpu_torch.ops.knn import knn_indices, knn_indices_points_normals
from sednet_tpu_torch.weights import flat_from_params, params_from_flat

from test_torch_port_losses import jax_triplet_draws
from test_torch_port_train import CFG_KW, B, K, N, _train_batch, flatten

OUTS = ("embedding", "type_log_prob", "edge_logits")


def _pair(**flags):
    """JAX's model and init parameters under `flags`, and the port's model
    built from the same config carrying them."""
    jcfg, cfg = JaxConfig(**CFG_KW, **flags), Config(**CFG_KW, **flags)
    jmodel = jtrain.build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((B, N, 6)))["params"]
    model = ttrain.build_model(cfg)
    model.load_state_dict(params_from_flat(flatten(params), ""), strict=True)
    return jmodel, params, model, cfg


@pytest.fixture(scope="module")
def points():
    b = _train_batch(seed=1)
    return np.concatenate([b["points"], b["normals"]], -1).astype(np.float32)


def _jax_out(jmodel, params, x, **kw):
    out = jmodel.apply({"params": params}, jnp.asarray(x), **kw)
    return out


def _np(t):
    return t.detach().double().numpy()


@pytest.fixture(scope="module")
def direct(points):
    """JAX's factored_gn=False forward and the gradient of a scalar of its
    three outputs (against fixed random weights), in one jitted call; the
    port's model on the same parameters and the weights."""
    jmodel, params, model, _ = _pair(factored_gn=False)
    rng = np.random.RandomState(5)
    ws = {name: rng.randn(*shape).astype(np.float32) for name, shape in
          (("embedding", (B, N, CFG_KW["embed"])),
           ("type_log_prob", (B, N, 6)), ("edge_logits", (B, N, 2)))}

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(points))
        return (sum(jnp.sum(getattr(out, k) * ws[k]) for k in ws),
                {k: getattr(out, k) for k in ws})

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(model=model, want=want, jgrads=flatten(jg), ws=ws)


# Direct float32 forward against JAX's factored_gn=False forward: atol
# 1e-4 (the rounding of two float32 stacks of seven layers).
def test_direct_forward_matches_jax(points, direct):
    with torch.no_grad():
        got = direct["model"](torch.from_numpy(points))
    for name in OUTS:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(direct["want"][name]),
                                   atol=1e-4, err_msg=name)


# The port's direct edge convolution against its factored one on the same
# parameters (JAX's own bar between its two branches, 2e-4,
# tests/test_models.py:209), layer by layer and for the whole model.
@pytest.mark.parametrize("c_in,c_out", [(6, 64), (64, 128)])
def test_direct_edge_conv_matches_factored(rng, c_in, c_out):
    conv = EdgeConv(c_in, c_out)
    with torch.no_grad():
        conv.conv.weight.normal_(0.0, 0.3)
        conv.gn.weight.uniform_(-1.5, 1.5)
        conv.gn.bias.normal_()
    x = torch.from_numpy(rng.randn(2, 200, c_in).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 200, (2, 200, 16))).long()
    with torch.no_grad():
        fac = conv(x, idx)
        conv.factored_gn = False
        direct = conv(x, idx)
    np.testing.assert_allclose(direct.numpy(), fac.numpy(), atol=2e-4)


def test_direct_model_matches_factored(points):
    _, _, fac, _ = _pair(factored_gn=True)
    _, _, direct, _ = _pair(factored_gn=False)
    x = torch.from_numpy(points)
    with torch.no_grad():
        a, b = fac(x), direct(x)
    for name in OUTS:
        np.testing.assert_allclose(_np(getattr(b, name)),
                                   _np(getattr(a, name)), atol=2e-4,
                                   err_msg=name)


# Gradients of the direct path against jax.grad of the same scalar (the
# three outputs against fixed random weights): 1e-4 relative L2 per leaf.
def test_direct_gradients_match_jax(points, direct):
    model, ws, jg = direct["model"], direct["ws"], direct["jgrads"]
    model.zero_grad()
    out = model(torch.from_numpy(points))
    sum(torch.sum(getattr(out, k) * torch.from_numpy(ws[k]))
        for k in ws).backward()
    tg = flat_from_params({k: p.grad for k, p in model.named_parameters()})
    assert set(tg) == set(jg)
    errs = {k: float(np.linalg.norm(tg[k] - jg[k])
                     / max(np.linalg.norm(jg[k]), 1e-30)) for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def _jax_graphs(jmodel, params, x):
    """The three graphs JAX's forward builds: the first on x, the others
    on conv1's and conv2's outputs (bf16 under model_bf16) as float32."""
    _, inter = jmodel.apply({"params": params}, jnp.asarray(x),
                            capture_intermediates=True)
    enc = inter["intermediates"]["encoder"]
    x1 = enc["conv1"]["__call__"][0].astype(jnp.float32)
    x2 = enc["conv2"]["__call__"][0].astype(jnp.float32)
    return ([np.asarray(jknn_pn(jnp.asarray(x), K)), np.asarray(jknn(x1, K)),
             np.asarray(jknn(x2, K))], [np.asarray(x1), np.asarray(x2)])


def _port_graphs(model, x):
    """The port's own three graphs and the features they are built on."""
    feats = {}
    hooks = [getattr(model.encoder, f"conv{i}").register_forward_hook(
        lambda m, a, out, i=i: feats.__setitem__(i, out.float()))
        for i in (1, 2)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return ([knn_indices_points_normals(x, K), knn_indices(feats[1], K),
             knn_indices(feats[2], K)], [feats[1].numpy(), feats[2].numpy()])


def _swapped_rows(idx_a, idx_b, feat, tol):
    """Rows whose neighbour sets differ, and whether each is a near-tie:
    on feat, the k-th distance of b's set within tol of a's."""
    same = (np.sort(idx_a, -1) == np.sort(idx_b, -1)).all(-1)
    bad = 0
    for bi, i in zip(*np.nonzero(~same)):
        d = ((feat[bi][None, i] - feat[bi]) ** 2).sum(-1)
        if abs(d[idx_b[bi, i]].max() - d[idx_a[bi, i]].max()) > tol:
            bad += 1
    return int((~same).sum()), bad


def _on_graphs(model, graphs):
    """model, its encoder made to take `graphs` in every forward."""
    forward = model.encoder.forward
    model.encoder.forward = lambda x, idx1=None, g=None: forward(x, idx1,
                                                                 graphs)
    return model


def _as_float64(model):
    """A float64 copy of the port's model, every layer computing in
    float64 (the direct branch)."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if hasattr(mod, "dtype") and not isinstance(mod, torch.Tensor):
            mod.dtype = torch.float64
    return m


@pytest.fixture(scope="module")
def bf16_pair(points):
    jmodel, params, model, cfg = _pair(model_bf16=True)
    x = torch.from_numpy(points)
    jgraphs, jfeats = _jax_graphs(jmodel, params, points)
    pgraphs, _ = _port_graphs(model, x)
    return dict(jmodel=jmodel, params=params, model=model, cfg=cfg, x=x,
                jgraphs=jgraphs, jfeats=jfeats, pgraphs=pgraphs)


# The graphs first: the port's layer-2 and layer-3 graphs, built on its own
# bf16 features, may differ from JAX's only in rows whose k-th and
# (k+1)-th neighbours lie within a bf16 step of the features' scale (a
# one-ulp difference between the two bf16 stacks can swap them). The
# first graph, on the float32 input, is JAX's exactly.
def test_bf16_graphs_differ_only_at_near_ties(bf16_pair):
    jg, pg, feats = bf16_pair["jgraphs"], bf16_pair["pgraphs"], \
        bf16_pair["jfeats"]
    np.testing.assert_array_equal(pg[0].numpy(), jg[0])
    for layer in (1, 2):
        f = feats[layer - 1]
        tol = 2.0 ** -6 * (1.0 + float((f * f).sum(-1).max()))
        swapped, bad = _swapped_rows(jg[layer], pg[layer].numpy(), f, tol)
        assert bad == 0, (layer, swapped, bad)
        assert swapped <= 0.05 * B * N, (layer, swapped)


# The bf16 forward on JAX's graphs against JAX's bf16 forward: within
# twice the larger of the two sides' distances from the float64 forward
# (the port's model in float64 on the same graphs), and the port no
# farther from float64 than twice JAX's distance. Each output is float32.
def test_bf16_forward_matches_jax(bf16_pair):
    p = bf16_pair
    graphs = [torch.from_numpy(g).long() for g in p["jgraphs"]]
    want = _jax_out(p["jmodel"], p["params"], p["x"].numpy())
    with torch.no_grad():
        got = p["model"](p["x"], graphs=graphs)
        ref = _as_float64(p["model"])(p["x"].double(), graphs=graphs)
    for name in OUTS:
        g, w, r = (_np(getattr(got, name)), np.asarray(getattr(want, name),
                                                       np.float64),
                   _np(getattr(ref, name)))
        assert getattr(got, name).dtype == torch.float32, name
        d_port, d_jax = np.abs(g - r).max(), np.abs(w - r).max()
        assert np.abs(g - w).max() <= 2.0 * max(d_port, d_jax), name
        assert d_port <= 2.0 * d_jax, (name, d_port, d_jax)


# One model_bf16 train step of the port against JAX's on the same batch,
# JAX's triplet draws and JAX's graphs: finite, every parameter still
# float32, the loss within twice the larger of the two sides' distances
# from the port's float64 loss on the same graphs and draws.
def test_bf16_train_step_matches_jax(bf16_pair):
    p = bf16_pair
    jcfg = JaxConfig(**CFG_KW, model_bf16=True)
    batch = _train_batch(seed=1)
    key = jax.random.PRNGKey(11)
    draws = jax_triplet_draws(key, batch["labels"], JaxTripletConfig(
        margin=jcfg.triplet_margin, max_segments=jcfg.ms_max_clusters))
    opt = jtrain.make_optimizer(jcfg)
    state = jtrain.TrainState(p["params"], opt.init(p["params"]),
                              jnp.int32(0))
    _, jm = jtrain.make_train_step(p["jmodel"], opt, jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    graphs = [torch.from_numpy(g).long() for g in p["jgraphs"]]
    tbatch = ttrain.to_device(batch, "cpu")
    tdraws = [torch.from_numpy(d.copy()) for d in draws]

    model = copy.deepcopy(p["model"])
    optimizer = ttrain.make_optimizer(p["cfg"], model.parameters())
    step = ttrain.make_train_step(model, optimizer, p["cfg"])
    _on_graphs(model, graphs)
    metrics = step(tbatch, tdraws)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(q.dtype == torch.float32 and torch.isfinite(q).all()
               for q in model.parameters())
    m64 = _on_graphs(_as_float64(p["model"]), graphs)
    b64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in tbatch.items()}
    with torch.no_grad():
        loss64, _ = ttrain.make_loss_fn(m64, p["cfg"])(b64, tdraws)
    got, want, ref = (float(metrics["loss"]), float(jm["loss"]),
                      float(loss64))
    assert np.isfinite(want)
    assert abs(got - want) <= 2.0 * max(abs(got - ref), abs(want - ref)), (
        got, want, ref)
