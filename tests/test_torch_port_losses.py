"""The port's training losses (sednet_tpu_torch.losses) and the plain
version of K6's gradient (ops.graph.gather_reduce_backward_plain) against
the JAX package on the CPU: values and gradients on the same numpy inputs,
the triplet loss on JAX's own random draws."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.losses import (TripletConfig as JaxTripletConfig,
                               edge_cls_loss as j_edge_cls,
                               edge_embedding_loss as j_edge_embed,
                               evaluate_type_miou as j_miou,
                               label_smoothing_nll as j_smooth,
                               primitive_nll as j_nll,
                               pull_push_embedding_loss as j_pull_push,
                               triplet_loss as j_triplet)
from sednet_tpu.losses.embedding import NEG_INF
from sednet_tpu.ops.graph import gather_neighbors as j_gather
from sednet_tpu_torch.losses import (TripletConfig, edge_cls_loss,
                                     edge_embedding_loss, evaluate_type_miou,
                                     label_smoothing_nll, primitive_nll,
                                     pull_push_embedding_loss, triplet_loss)
from sednet_tpu_torch.losses.embedding import sample_draws
from sednet_tpu_torch.ops.graph import (backward_error_bound,
                                        gather_reduce_backward,
                                        gather_reduce_backward_plain,
                                        gather_reduce_plain)

RTOL, ATOL = 1e-5, 1e-6


def jax_triplet_draws(key, labels, cfg):
    """JAX's draws inside `sednet_tpu.losses.triplet_loss`
    (`sednet_tpu/losses/embedding.py:62-71`), made the same way from the
    same key: (sample_idx, seg_a, seg_b) as numpy."""
    return tuple(np.asarray(t) for t in _jax_draws(key, jnp.asarray(labels),
                                                    cfg))


@functools.partial(jax.jit, static_argnums=2)
def _jax_draws(key, labels, cfg):
    b = labels.shape[0]
    s, m, p = cfg.max_segments, cfg.samples_per_segment, cfg.num_pairs
    member = labels[:, None, :] == jnp.arange(s, dtype=labels.dtype)[
        None, :, None]
    present = member.any(-1)
    k_samp, k_a, k_b = jax.random.split(key, 3)
    samp_logits = jnp.where(member[:, :, None, :], 0.0, NEG_INF)
    sample_idx = jax.random.categorical(k_samp, samp_logits, axis=-1,
                                        shape=(b, s, m))
    pair_logits = jnp.where(present, 0.0, NEG_INF)[:, None, :]
    seg_a = jax.random.categorical(k_a, pair_logits, axis=-1, shape=(b, p))
    seg_b = jax.random.categorical(k_b, pair_logits, axis=-1, shape=(b, p))
    return sample_idx, seg_a, seg_b


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _grad_pair(jfn, tfn, *arrays):
    """Value and gradient with respect to every array, in JAX and torch."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    # an input the loss does not use has no torch gradient, JAX's zeros
    return (jv, jg), (tv.detach().numpy(),
                      [np.zeros_like(a) if t.grad is None else t.grad.numpy()
                       for a, t in zip(arrays, ts)])


def _check(jfn, tfn, *arrays):
    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, *arrays)
    _close(tv, jv)
    for g, w in zip(tg, jg):
        _close(g, w)


def _log_probs(rng, b, n, c):
    x = rng.randn(b, n, c).astype(np.float32)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _labels(rng, b, n, kind):
    """Instance labels: "mixed" (several segments, -1 noise points),
    "single" (shape 0 one segment), each segment at least 4 points."""
    lab = np.sort(rng.randint(0, 5, (b, n)), axis=1).astype(np.int32)
    lab[:, :4] = 0
    for s in range(5):
        lab[:, 4 + 4 * s: 8 + 4 * s] = s
    if kind == "mixed":
        lab[:, -6:] = -1
    if kind == "single":
        lab[0] = 2
    return lab


@pytest.mark.parametrize("smooth", [None, 0.0, 0.025, 0.3])
def test_type_nll_and_label_smoothing_match_jax(rng, smooth):
    lp = _log_probs(rng, 2, 64, 6)
    target = rng.randint(0, 6, (2, 64)).astype(np.int32)
    if smooth is None:
        _check(lambda x: j_nll(x, jnp.asarray(target)),
               lambda x: primitive_nll(x, torch.from_numpy(target)), lp)
    else:
        _check(lambda x: j_smooth(x, jnp.asarray(target), smooth),
               lambda x: label_smoothing_nll(x, torch.from_numpy(target),
                                             smooth), lp)


# Argmax ties go to the first index on both sides (rows 0-9 are all-equal
# log-probs), and absent classes count eps / eps = 1.
@pytest.mark.parametrize("seed", [0, 1])
def test_type_miou_matches_jax(seed):
    rng = np.random.RandomState(seed)
    lp = _log_probs(rng, 3, 80, 6)
    lp[:, :10] = -np.log(6.0)
    gt = rng.randint(0, 4, (3, 80)).astype(np.int32)
    _close(evaluate_type_miou(torch.from_numpy(gt), torch.from_numpy(lp)),
           j_miou(jnp.asarray(gt), jnp.asarray(lp)))


# Shape 1 has all-zero weights and is dropped from the mean.
def test_edge_cls_loss_matches_jax(rng):
    logits = rng.randn(3, 50, 2).astype(np.float32)
    labels = rng.randint(0, 2, (3, 50)).astype(np.int32)
    w = rng.uniform(0.5, 2.0, (3, 50)).astype(np.float32)
    w[1] = 0.0
    _check(lambda x: j_edge_cls(x, jnp.asarray(labels), jnp.asarray(w)),
           lambda x: edge_cls_loss(x, torch.from_numpy(labels),
                                   torch.from_numpy(w)), logits)


@pytest.mark.parametrize("kind", ["mixed", "single", "clean"])
def test_pull_push_matches_jax(rng, kind):
    feat = rng.randn(2, 60, 8).astype(np.float32)
    lab = _labels(rng, 2, 60, kind)
    (jv, jg), _ = _grad_pair(
        lambda f: j_pull_push(f, jnp.asarray(lab), max_segments=8)[0],
        lambda f: pull_push_embedding_loss(f, torch.from_numpy(lab),
                                           max_segments=8)[0], feat)
    got = pull_push_embedding_loss(torch.from_numpy(feat),
                                   torch.from_numpy(lab), max_segments=8)
    want = j_pull_push(jnp.asarray(feat), jnp.asarray(lab), max_segments=8)
    for g, w in zip(got, want):
        _close(g, w)
    _check(lambda f: j_pull_push(f, jnp.asarray(lab), max_segments=8)[0],
           lambda f: pull_push_embedding_loss(
               f, torch.from_numpy(lab), max_segments=8)[0], feat)
    if kind == "single":   # no pair in shape 0: push is shape 1's alone
        assert float(got[2]) == pytest.approx(
            float(pull_push_embedding_loss(
                torch.from_numpy(feat[1:]), torch.from_numpy(lab[1:]),
                max_segments=8)[2]) / 2, rel=1e-6)


# A class of one point sits on its own centre: the port's gradient is
# finite there (vector_norm's subgradient 0, as the reference's torch.norm);
# JAX's sqrt at 0 makes every gradient NaN. The values agree.
def test_pull_push_single_point_class_gradient_is_finite(rng):
    feat = rng.randn(1, 12, 4).astype(np.float32)
    lab = np.array([[0] * 6 + [1] * 5 + [2]], np.int32)
    (jv, jg), (tv, tg) = _grad_pair(
        lambda f: j_pull_push(f, jnp.asarray(lab), max_segments=5)[0],
        lambda f: pull_push_embedding_loss(f, torch.from_numpy(lab),
                                           max_segments=5)[0], feat)
    _close(tv, jv)
    assert np.isnan(np.asarray(jg[0])).all()
    assert np.isfinite(tg[0]).all() and np.abs(tg[0][0, -1]).max() > 0


# The top `edges_num` points by edge logit (distinct logits: no tie at the
# cut), with and without the type NLL on them; gradients with respect to the
# embedding and the type log-probs (the edge logits only select).
@pytest.mark.parametrize("use_type", [False, True])
@pytest.mark.parametrize("edges_num", [20, 60])
def test_edge_embedding_loss_matches_jax(rng, use_type, edges_num):
    b, n = 2, 60
    logits = rng.randn(b, n, 2).astype(np.float32)
    logits[..., 1] = rng.permutation(n * b).reshape(b, n) * 0.01
    # the first 20 points (segments of 8, 4, 4 and 4 points) lead: no class
    # of one point in the subset, where JAX's pull gradient is NaN
    logits[:, :20, 1] += 100.0
    feat = rng.randn(b, n, 8).astype(np.float32)
    lab = _labels(rng, b, n, "mixed")
    prim = rng.randint(0, 6, (b, n)).astype(np.int32)
    lp = _log_probs(rng, b, n, 6)

    def jfn(f, t):
        return j_edge_embed(jnp.asarray(logits), f, jnp.asarray(lab),
                            edges_num=edges_num, use_type=use_type,
                            primitives=jnp.asarray(prim), type_log_prob=t,
                            max_segments=8)

    def tfn(f, t):
        return edge_embedding_loss(torch.from_numpy(logits), f,
                                   torch.from_numpy(lab), edges_num=edges_num,
                                   use_type=use_type,
                                   primitives=torch.from_numpy(prim),
                                   type_log_prob=t, max_segments=8)

    _check(jfn, tfn, feat, lp)


@pytest.mark.parametrize("kind", ["mixed_segments", "single"])
def test_triplet_loss_matches_jax_on_its_draws(kind):
    rng = np.random.RandomState(5)
    cfg = TripletConfig(max_segments=8)
    jcfg = JaxTripletConfig(max_segments=8)
    emb = rng.randn(2, 64, 16).astype(np.float32)
    lab = _labels(rng, 2, 64, "clean" if kind != "single" else "single")
    key = jax.random.PRNGKey(3)
    draws = [torch.from_numpy(d.copy())
             for d in jax_triplet_draws(key, lab, jcfg)]
    _check(lambda e: j_triplet(key, e, jnp.asarray(lab), jcfg),
           lambda e: triplet_loss(e, torch.from_numpy(lab), cfg, draws=draws),
           emb)


# The port's own draws: samples lie in their segment, pairs among present
# segments, uniform within a few sigma; absent segments give valid indices.
def test_triplet_sample_draws_are_uniform_members():
    rng = np.random.RandomState(2)
    lab = np.repeat(np.array([0, 1, 1, 4, 4, 4]), 50)[None]
    lab = np.concatenate([lab, rng.permutation(lab[0])[None]]).astype(
        np.int32)
    cfg = TripletConfig(max_segments=6, samples_per_segment=2000,
                        num_pairs=3000)
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(lab)
    sample_idx, seg_a, seg_b = sample_draws(t, cfg, gen)
    assert sample_idx.shape == (2, 6, 2000) and seg_a.shape == (2, 3000)
    assert int(sample_idx.min()) >= 0 and int(sample_idx.max()) < 300
    for b in range(2):
        for s in (0, 1, 4):
            got = t[b][sample_idx[b, s]]
            assert bool((got == s).all())
            members = torch.nonzero(t[b] == s)[:, 0]
            hist = torch.bincount(sample_idx[b, s], minlength=300)[members]
            exp = 2000 / len(members)
            assert float((hist - exp).abs().max()) < 6 * exp ** 0.5
        for seg in (seg_a[b], seg_b[b]):
            hist = torch.bincount(seg, minlength=6)
            assert int(hist[[2, 3, 5]].sum()) == 0
            assert float((hist[[0, 1, 4]] - 1000).abs().max()) < 6 * 1000 ** 0.5
    loss = triplet_loss(torch.randn(2, 300, 8, generator=gen), t,
                        TripletConfig(max_segments=6), generator=gen)
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="generator"):
        triplet_loss(torch.zeros(2, 300, 8), t)


def _graph(seed, b, n, c, k, ties):
    rng = np.random.RandomState(seed)
    a = (rng.randint(-2, 3, (b, n, c)) if ties else rng.randn(b, n, c)
         ).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k))
    idx[:, ::3, 1] = idx[:, ::3, 0]          # a neighbour listed twice
    if b > 1:
        # out of range: clamps to 0 and to n - 1. JAX's gather of one shape
        # (B = 1) indexes x[0][idx] without its clamp: a negative index
        # wraps from the end, and the VJP drops an index past the end that
        # its forward clamped, so B = 1 has none
        idx[0, :5, 0] = -3
        idx[-1, 7, :4] = n + 11
    cot = [rng.randn(b, n, c).astype(np.float32) for _ in range(3)]
    return a, idx, cot


# K6's gradient: the explicit formula against jax.vjp of JAX's gather and
# its three reductions (max ties split evenly, as reduce_max's VJP), and
# against torch autograd of gather_reduce_plain; exact ties come from a
# table of five values, out-of-range entries clamp. The gradient sums about
# K terms of magnitude up to ~5 in other orders: atol 1e-5 and rtol 1e-6
# (values reach ~30, where a float32 ulp is 1.9e-6); and within the
# rounding bound of any two orders (backward_error_bound).
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,c,k", [(1, 8, 4), (2, 64, 16), (3, 5, 9)])
def test_gather_reduce_backward_plain_matches_jax_and_autograd(b, c, k, ties):
    n = 40
    a, idx, cot = _graph(b + c + k, b, n, c, k, ties)

    def jfn(x):
        g = j_gather(x, jnp.asarray(idx.astype(np.int32)))
        return g.sum(2), (g * g).sum(2), g.max(2)

    out, vjp = jax.vjp(jfn, jnp.asarray(a))
    want = np.asarray(vjp(tuple(jnp.asarray(g) for g in cot))[0])
    at = torch.from_numpy(a)
    it = torch.from_numpy(idx)
    mx = gather_reduce_plain(at, it)[2]
    np.testing.assert_array_equal(mx.numpy(), np.asarray(out[2]))
    tcot = [torch.from_numpy(g) for g in cot]
    got = gather_reduce_backward_plain(at, it, mx, *tcot)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)

    ag = at.clone().requires_grad_()
    torch.autograd.backward(gather_reduce_plain(ag, it), tcot)
    np.testing.assert_allclose(got.numpy(), ag.grad.numpy(), rtol=1e-6,
                               atol=1e-5)
    bound = backward_error_bound(at, it, mx, *tcot)
    assert bool(((got.double() - ag.grad.double()).abs() <= bound).all())
    # the public wrapper takes the plain version on the CPU, launching nothing
    before = gather_reduce_backward.launches
    assert torch.equal(gather_reduce_backward(at, it, mx, *tcot), got)
    assert gather_reduce_backward.launches == before
