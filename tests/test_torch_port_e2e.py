"""The port's ParseNet model and end-to-end trainer
(sednet_tpu_torch.models.parsenet, sednet_tpu_torch.parsenet_e2e) against
the JAX package's on the CPU, at N 128-600, k 4-8, embed 8-16, B 2.

Tolerances: ParseNetEmbedding's outputs at atol 1e-4; cluster_for_matching
and build_match_arrays equal; e2e_fitting_loss at rtol 1e-5 and its
gradient at 1e-3 relative L2 where the loss is well conditioned, and, on
`test_e2e_fitting_loss_grad_flows`' near-perfect fit (a loss of 1e-8 whose
float32 rounding is 1e-3 of it), both sides held to the port's float64
loss instead; one e2e train step's metrics at rtol 1e-4 and its gradients
at 1e-3 relative L2 per leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sednet_tpu import parsenet_e2e as je2e
from sednet_tpu import train as jtrain
from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.data.synthetic import make_synthetic_shape
from sednet_tpu.losses import TripletConfig as JaxTripletConfig
from sednet_tpu.models.parsenet import ParseNetEmbedding as JaxParseNet
from sednet_tpu_torch import parsenet_e2e as pe2e
from sednet_tpu_torch import train as ttrain
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.models.parsenet import ParseNetEmbedding
from sednet_tpu_torch.weights import (flat_from_params, flatten_tree,
                                      params_from_flat, parsenet_from_params)

from test_torch_port_losses import jax_triplet_draws


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- ParseNetEmbedding --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(mode=5, k=8, emb_size=16),
    dict(mode=0, k=4, emb_size=8, late_fusion=False, edge_module=False),
    dict(mode=5, k=6, emb_size=8, combine_label_prim=False)])
def test_parsenet_embedding_matches_jax(rng, kw):
    c = 6 if kw["mode"] == 5 else 3
    x = rng.randn(2, 128, c).astype(np.float32)
    if c == 6:
        x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    jmodel = JaxParseNet(**kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    model = parsenet_from_params(flatten_tree(params), "", device="cpu", **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    width = kw["emb_size"] + (0 if kw.get("late_fusion") is False else 6 + (
        0 if kw.get("edge_module") is False else 2))
    assert got.embedding.shape == (2, 128, width)
    for name in ("embedding", "type_log_prob", "type_logits", "edge_logits"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
            continue
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=name)


def test_parsenet_state_dict_round_trips_to_flax_names(rng):
    jmodel = JaxParseNet(emb_size=8, k=4)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 32, 6)))["params"]
    flat = flatten_tree(params)
    model = ParseNetEmbedding(emb_size=8, k=4)
    model.load_state_dict(params_from_flat(flat, ""), strict=True)
    back = flat_from_params(model.state_dict())
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], np.asarray(flat[key]))


# --- phases A and B -----------------------------------------------------------

def _oracle(seed, n, n_segments, noise):
    """A synthetic cloud and a noisy one-hot embedding of its segments (the
    case of JAX's test_e2e_fitting_loss_grad_flows, parametrised)."""
    rng = np.random.RandomState(seed)
    d = make_synthetic_shape(rng, n_points=n, n_segments=n_segments)
    emb = (np.eye(8, dtype=np.float32)[d["labels"]]
           + noise * rng.randn(n, 8).astype(np.float32))
    return d, emb


def _jax_phase_ab(d, emb, key, n):
    cid, cmask, bw = je2e.cluster_for_matching(
        key, jnp.asarray(emb), num_samples=n, quantile=0.2)
    arrays = je2e.build_match_arrays(np.asarray(cid), np.asarray(cmask),
                                     d["labels"], d["prim"])
    return (np.asarray(cid), np.asarray(cmask), np.float32(bw)), arrays


CASES = {"grad_flows": (0, 300, 3, 0.05), "all_types": (3, 600, 4, 0.1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_for_matching_matches_jax(case):
    seed, n, segs, noise = CASES[case]
    d, emb = _oracle(seed, n, segs, noise)
    key = jax.random.PRNGKey(seed)
    (cid, cmask, bw), _ = _jax_phase_ab(d, emb, key, n)
    sel = torch.from_numpy(np.array(jax.random.permutation(key, n)[:n]))
    tcid, tcmask, tbw = pe2e.cluster_for_matching(
        torch.from_numpy(emb), num_samples=n, quantile=0.2, sel=sel)
    np.testing.assert_array_equal(tcid.numpy(), cid)
    np.testing.assert_array_equal(tcmask.numpy(), cmask)
    np.testing.assert_allclose(float(tbw), float(bw), rtol=1e-6)
    assert tcid.dtype == torch.int64 and tbw.dtype == torch.float32


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_match_arrays_equal_jax(case):
    seed, n, segs, noise = CASES[case]
    d, emb = _oracle(seed, n, segs, noise)
    (cid, cmask, _), want = _jax_phase_ab(d, emb, jax.random.PRNGKey(seed), n)
    got = pe2e.build_match_arrays(cid, cmask, d["labels"], d["prim"],
                                  device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).sum() >= 2


# --- phase C: the fitting loss --------------------------------------------------

def _fit_loss_pair(d, emb, arrays, bw):
    cr, st, gm, _ = arrays

    def f(e):
        return je2e.e2e_fitting_loss(
            e, jnp.asarray(d["points"]), jnp.asarray(d["normals"]),
            jnp.asarray(cr), jnp.asarray(st), jnp.asarray(gm), bw)

    jl, jg = jax.value_and_grad(f)(jnp.asarray(emb))

    def port(dtype):
        e = torch.from_numpy(emb).to(dtype).requires_grad_()
        loss = pe2e.e2e_fitting_loss(
            e, torch.from_numpy(d["points"]).to(dtype),
            torch.from_numpy(d["normals"]).to(dtype), torch.from_numpy(cr),
            torch.from_numpy(st), torch.from_numpy(gm),
            torch.tensor(float(bw), dtype=dtype))
        loss.backward()
        return float(loss.detach()), e.grad.double().numpy()

    return (float(jl), np.asarray(jg, np.float64)), port(torch.float32), \
        port(torch.float64)


def test_e2e_fitting_loss_and_grad_match_jax():
    """A well-conditioned case with a plane, a sphere, a cylinder and a
    cone matched: value at rtol 1e-5, gradient at 1e-3 relative L2."""
    seed, n, segs, noise = CASES["all_types"]
    d, emb = _oracle(seed, n, segs, noise)
    (_, _, bw), arrays = _jax_phase_ab(d, emb, jax.random.PRNGKey(seed), n)
    assert sorted(set(arrays[1][arrays[1] > 0])) == [1, 2, 3, 4]
    (jl, jg), (tl, tg), _ = _fit_loss_pair(d, emb, arrays, bw)
    assert tl > 1e-3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tg).all() and np.abs(tg).sum() > 0
    assert rel_l2(tg, jg) <= 1e-3


# On the near-perfect fit of test_e2e_fitting_loss_grad_flows the loss is
# 1.27e-8: the mean of squared point-to-plane distances near 1e-4, each the
# difference of terms near 1 whose float32 rounding is 1e-7, so either
# side's float32 loss lies up to 1e-3 of it from the float64 loss (JAX's
# 9.0e-4, the port's 4.5e-4) and its gradient up to 3e-3 relative L2 (JAX's
# 2.6e-3, the port's 8.8e-4). rtol 1e-5 between the two float32 losses is
# below what either gives, so both are held to the port's float64 loss on
# the same arrays within the TOL below: JAX's (which fails if the port's
# arithmetic were another function) and the port's.
NEAR_PERFECT_LOSS_TOL, NEAR_PERFECT_GRAD_TOL = 2e-3, 5e-3


def test_e2e_fitting_loss_grad_flows_near_perfect_fit():
    seed, n, segs, noise = CASES["grad_flows"]
    d, emb = _oracle(seed, n, segs, noise)
    (_, _, bw), arrays = _jax_phase_ab(d, emb, jax.random.PRNGKey(seed), n)
    (jl, jg), (tl, tg), (el, eg) = _fit_loss_pair(d, emb, arrays, bw)
    assert 0 < el < 0.1 and np.isfinite(tg).all() and np.abs(tg).sum() > 0
    for side, (loss, grad) in (("JAX", (jl, jg)), ("port", (tl, tg))):
        assert abs(loss - el) / el <= NEAR_PERFECT_LOSS_TOL, side
        assert rel_l2(grad, eg) <= NEAR_PERFECT_GRAD_TOL, side


def test_e2e_fitting_loss_fits_each_type_on_its_segments(monkeypatch):
    """The port fits each primitive only on the segments of its type (JAX's
    vmapped switch evaluates all four fits on all 50 segments), so an
    unmatched segment costs no fit. On a flat cloud, where JAX's discarded
    cylinder and cone fits take the SVD of rank-one normals, both sides
    give the same finite loss and gradient."""
    seed, n, segs, noise = CASES["all_types"]
    d, emb = _oracle(seed, n, segs, noise)
    (_, _, bw), arrays = _jax_phase_ab(d, emb, jax.random.PRNGKey(seed), n)
    calls = []
    for name in ("fit_plane", "fit_sphere", "fit_cylinder", "fit_cone"):
        fn = getattr(pe2e, name)
        monkeypatch.setattr(pe2e, name, lambda *a, _f=fn, _n=name: (
            calls.append((_n, a[-1].shape[0])), _f(*a))[1])
    _fit_loss_pair(d, emb, arrays, bw)
    st = arrays[1]
    want = [(name, int((st == code).sum())) for name, code in (
        ("fit_plane", 1), ("fit_sphere", 2), ("fit_cylinder", 3),
        ("fit_cone", 4)) if (st == code).any()]
    # the float32 and the float64 evaluation, each one call a type
    assert calls == want + want
    monkeypatch.undo()

    rng = np.random.RandomState(0)
    flat = {"points": np.concatenate([rng.uniform(-1, 1, (300, 2)),
                                      0.01 * rng.randn(300, 1)],
                                     1).astype(np.float32),
            "normals": np.tile(np.float32([[0, 0, 1]]), (300, 1)),
            "labels": np.zeros(300, np.int32), "prim": np.ones(300, np.int32)}
    emb = np.eye(8, dtype=np.float32)[flat["labels"]] + 0.05 * rng.randn(
        300, 8).astype(np.float32)
    (_, _, bw), arrays = _jax_phase_ab(flat, emb, jax.random.PRNGKey(0), 300)
    assert list(arrays[1][:2]) == [1, 0]
    (jl, jg), (tl, tg), _ = _fit_loss_pair(flat, emb, arrays, bw)
    assert np.isfinite(jg).all() and np.isfinite(tg).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert rel_l2(tg, jg) <= 1e-3


def test_svd_gradient_at_a_repeated_singular_value_is_nan_on_both_sides():
    """The fits' hazard: the smallest right singular vector of a rank-one
    (P, 3) matrix (two singular values 0) has no defined gradient, and
    both torch's and JAX's SVD backward give NaN there, so a fit on such a
    segment gives NaN on either side; on distinct singular values both
    agree."""
    rng = np.random.RandomState(0)
    w = rng.rand(50).astype(np.float32)
    for normals, finite in ((np.tile(np.float32([[0, 0, 1]]), (50, 1)), False),
                            (rng.randn(50, 3).astype(np.float32), True)):
        t = torch.from_numpy(w).requires_grad_()
        torch.linalg.svd(t[:, None] * torch.from_numpy(normals),
                         full_matrices=False)[2][-1].sum().backward()
        jg = jax.grad(lambda v: jnp.linalg.svd(
            v[:, None] * jnp.asarray(normals),
            full_matrices=False)[2][-1].sum())(jnp.asarray(w))
        assert bool(torch.isfinite(t.grad).all()) == finite
        assert bool(np.isfinite(np.asarray(jg)).all()) == finite
        if finite:   # the vector's sign is the solver's: compare |grad|
            np.testing.assert_allclose(np.abs(t.grad.numpy()),
                                       np.abs(np.asarray(jg)), atol=1e-4)


def test_e2e_fitting_loss_without_segments_is_zero():
    emb = torch.randn(64, 8, requires_grad=True)
    pts = torch.randn(64, 3)
    loss = pe2e.e2e_fitting_loss(
        emb, pts, pts, torch.zeros(pe2e.MAX_SEGS, dtype=torch.int32),
        torch.zeros(pe2e.MAX_SEGS, dtype=torch.int32),
        torch.zeros(pe2e.MAX_SEGS, 64), torch.tensor(0.1))
    loss.backward()
    assert float(loss.detach()) == 0.0 and not emb.grad.any()


# --- one e2e train step ----------------------------------------------------------

N, K, EMBED, B = 128, 4, 8, 2
STEP_KW = dict(num_points=N, knn=K, embed=EMBED, edge_topk=16, batch_size=B)


def _record_grads():
    """A gradient transformation that keeps the gradients in its state and
    passes them on, so that JAX's own step gives them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _step_batch():
    rng = np.random.RandomState(5)
    shapes = [make_synthetic_shape(rng, N, 3) for _ in range(B)]
    batch = {k: np.stack([s[k] for s in shapes])
             for k in ("points", "normals", "labels", "prim")}
    batch["labels"] = batch["labels"].astype(np.int32)
    return batch


def _truth_arrays(batch):
    """Phase-B arrays matched to the true segments themselves: each
    segment's first point as its center, its majority type's fit code, its
    mask (build_match_arrays' 100-point floor would leave none at N 128)."""
    rows = np.zeros((B, pe2e.MAX_SEGS), np.int32)
    types = np.zeros((B, pe2e.MAX_SEGS), np.int32)
    masks = np.zeros((B, pe2e.MAX_SEGS, N), np.float32)
    for i in range(B):
        for s in np.unique(batch["labels"][i]):
            g = batch["labels"][i] == s
            rows[i, s] = np.nonzero(g)[0][0]
            vals, counts = np.unique(batch["prim"][i][g], return_counts=True)
            types[i, s] = pe2e._TYPE_TO_F.get(int(vals[np.argmax(counts)]), 0)
            masks[i, s] = g
    return rows, types, masks


@pytest.fixture(scope="module")
def e2e_step_pair():
    jcfg, cfg = JaxConfig(**STEP_KW), Config(**STEP_KW)
    batch = _step_batch()
    arrays = _truth_arrays(batch)
    assert (arrays[1] > 0).sum() >= 3
    bws = np.float32([0.3, 0.25])
    jmodel = jtrain.build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, N, 6)))["params"]
    flat0 = flatten_tree(params)
    opt = optax.chain(_record_grads(), jtrain.make_optimizer(jcfg))
    state = je2e.E2EState(params, opt.init(params), jnp.int32(0))
    key = jax.random.PRNGKey(7)
    draws = jax_triplet_draws(key, batch["labels"], JaxTripletConfig(
        max_segments=je2e.MAX_SEGS, margin=jcfg.triplet_margin))
    step = je2e.make_e2e_train_step(jmodel, opt, jcfg)
    new, jmetrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         tuple(jnp.asarray(a) for a in arrays),
                         jnp.asarray(bws), key)
    jgrads = {k: np.asarray(v) for k, v in
              flatten_tree(jax.device_get(new.opt_state[0])).items()}

    model = ttrain.build_model(cfg)
    model.load_state_dict(params_from_flat(flat0, ""), strict=True)
    optimizer = ttrain.make_optimizer(cfg, model.parameters())
    tstep = pe2e.make_e2e_train_step(model, optimizer, cfg)
    tmetrics = tstep({k: torch.from_numpy(v) for k, v in batch.items()},
                     tuple(torch.from_numpy(a) for a in arrays),
                     torch.from_numpy(bws),
                     [torch.from_numpy(d.copy()) for d in draws])
    # the edge head feeds no term of this loss: no torch gradient, JAX's zeros
    tgrads = flat_from_params({k: torch.zeros_like(p) if p.grad is None
                               else p.grad
                               for k, p in model.named_parameters()})
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, jgrads=jgrads,
                tgrads=tgrads)


@pytest.mark.parametrize("name", ["loss", "emb", "type", "fit"])
def test_e2e_train_step_metrics_match_jax(e2e_step_pair, name):
    got = float(e2e_step_pair["tmetrics"][name])
    want = float(e2e_step_pair["jmetrics"][name])
    assert np.isfinite(got)
    if name == "fit":
        assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_e2e_train_step_gradients_match_jax(e2e_step_pair):
    jg, tg = e2e_step_pair["jgrads"], e2e_step_pair["tgrads"]
    assert jg.keys() == tg.keys() and len(jg) == 45
    errs = {k: rel_l2(tg[k], jg[k]) for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_e2e_train_batch_runs_phases_a_b_c():
    """e2e_train_batch end to end on the CPU: two forwards, the clustering,
    the match, the step, every metric finite, the state one step on, each
    phase's range timed, and the triplet draws handed to the step."""
    cfg = Config(**{**STEP_KW, "num_points": 600})
    rng = np.random.RandomState(3)
    shapes = [make_synthetic_shape(rng, 600, 4) for _ in range(B)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in shapes]))
             for k in ("points", "normals", "labels", "prim")}
    gen = torch.Generator().manual_seed(0)
    model = ttrain.init_training(cfg, "cpu")[0]
    optimizer = ttrain.make_optimizer(cfg, model.parameters())
    step = pe2e.make_e2e_train_step(model, optimizer, cfg)
    seen = []

    def recording(batch, arrays, bws, draws):
        seen.append((arrays, bws, draws))
        return step(batch, arrays, bws, draws)

    timings = {}
    state = ttrain.TrainState(model, optimizer, 0)
    state, metrics = pe2e.e2e_train_batch(model, state, batch, cfg, recording,
                                          gen, timings=timings)
    assert state.step == 1 and set(timings) == set(pe2e.STAGES)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    (rows, types, masks), bws, draws = seen[0]
    assert rows.shape == (B, pe2e.MAX_SEGS) and masks.shape == (
        B, pe2e.MAX_SEGS, 600)
    assert bws.dtype == torch.float32 and (bws >= 0.003).all()
    assert draws[0].shape == (B, pe2e.MAX_SEGS, 30)
