"""The port's fitting driver and residual evaluation (sednet_tpu_torch.fit
driver and evaluation, metrics.relaxed_iou_fast) against the JAX package's
on the CPU, with SplineNet at full width (grid 20, k 10, sample grid 30) on
the same weights: the port's `init_like_flax` draws them from a seed and
they are carried into JAX's flax variables.

Tolerances: geometric fits at atol 2e-4 after the sign canonicalisation
of `test_torch_port_fit._canon`; spline surfaces at atol 1e-4 (a kNN
near-tie of the resampled cloud may move one point's max);
residuals at rtol 1e-4; coverage within one point a shape. The refit
(`if_optimize`) is held to JAX's own refit of the port's surface and
resampled points to 1e-6, not to JAX's end-to-end refit: its Hungarian
matchings turn the surfaces' rounding differences into other, equally good
matchings."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.data.synthetic import (make_synthetic_shape, sample_cylinder,
                                       sample_plane)
from sednet_tpu.fit import driver as jdrv
from sednet_tpu.fit import evaluation as jev
from sednet_tpu.metrics import relaxed_iou_fast as jax_relaxed_iou
from sednet_tpu_torch.fit import driver as tdrv
from sednet_tpu_torch.fit import evaluation as tev
from sednet_tpu_torch.fit.bspline import (sample_from_control_grid,
                                          uniform_knot_bspline)
from sednet_tpu_torch.metrics import relaxed_iou_fast
from sednet_tpu_torch.models.init import init_like_flax
from sednet_tpu_torch.models.splinenet import SplineNet
from sednet_tpu_torch.weights import flat_from_params

from test_torch_port_fit import SLOTS, _canon
from test_torch_port_splinenet import unflatten


def jax_variables(model):
    """The flax variable dict of a port SplineNet: its parameters under
    "params", BatchNorm's running statistics under "batch_stats"."""
    flat = {}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        arr = value.numpy().copy()
        if leaf in ("mean", "var"):
            flat["/".join(["batch_stats", *path, leaf])] = arr
        else:
            flat.update({"params/" + k: v for k, v in flat_from_params(
                {key: value}).items()})
    return unflatten(flat)


@pytest.fixture(scope="module")
def fitters():
    """(JAX FittingModule, port FittingModule) with the same open and
    closed SplineNet weights."""
    nets = [init_like_flax(SplineNet(), torch.Generator().manual_seed(s))
            for s in (21, 22)]
    rng = np.random.RandomState(23)
    for net in nets:   # running statistics that shape the output
        for name, buf in net.named_buffers():
            buf.copy_(torch.from_numpy(
                rng.uniform(0.5, 2.0, buf.shape).astype(np.float32)
                if name.endswith("var") else
                (rng.randn(*buf.shape) * 0.1).astype(np.float32)))
    jf = jdrv.FittingModule(open_spline_params=jax_variables(nets[0]),
                            closed_spline_params=jax_variables(nets[1]))
    tf = tdrv.FittingModule(nets[0], nets[1], device="cpu")
    return jf, tf


def spline_patch(rng, n):
    """n noisy points of a smooth random B-spline patch (6 x 6 control
    grid) sampled through the port's `sample_from_control_grid`."""
    nu, nv = uniform_knot_bspline(6, 6, 3, 3, 40)
    g = np.stack(np.meshgrid(np.linspace(-0.5, 0.5, 6),
                             np.linspace(-0.5, 0.5, 6), indexing="ij"), -1)
    ctrl = np.concatenate([g, rng.randn(6, 6, 1) * 0.15], -1)
    surf = sample_from_control_grid(
        torch.from_numpy(nu), torch.from_numpy(nv),
        torch.from_numpy(ctrl.reshape(1, 36, 3).astype(np.float32)), 6,
        6)[0].numpy()
    pts = surf[rng.choice(surf.shape[0], n, replace=False)]
    return (pts + rng.randn(n, 3) * 0.002).astype(np.float32)


def _segments():
    rng = np.random.RandomState(24)
    pl, pl_n, _ = sample_plane(rng, 400)
    cy, cy_n, _ = sample_cylinder(rng, 500)
    return [{"id": 0, "label": 2, "points": spline_patch(rng, 700)},
            {"id": 1, "label": 0, "points": spline_patch(rng, 700)},
            {"id": 2, "label": 1, "points": pl, "normals": pl_n},
            {"id": 3, "label": 4, "points": cy, "normals": cy_n},
            {"id": 4, "label": 1, "points": pl[:10], "normals": pl_n[:10]},
            {"id": 5, "label": 8, "points": pl[:60], "normals": pl_n[:60]},
            {"id": 6, "label": 11, "points": pl, "normals": pl_n}]


def _hold_shape(got, want):
    """Port parameters and reconstructions against JAX's, per segment."""
    (tp, tr), (jp, jr) = got, want
    assert list(tp) == list(jp) and list(tr) == list(jr)
    for k, v in jp.items():
        if v is None:
            assert tp[k] is None and tr[k] is None
        elif v[0] in ("open-spline", "closed-spline"):
            assert tp[k][0] == v[0]
            assert tuple(tr[k].shape) == np.asarray(jr[k]).shape
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                       atol=1e-4)
        else:
            assert tp[k][0] == v[0]
            row_t, row_j = np.zeros(22), np.zeros(22)
            row_t[SLOTS[v[0]]] = np.concatenate(
                [np.ravel(a) for a in tp[k][1:]])
            row_j[SLOTS[v[0]]] = np.concatenate(
                [np.ravel(np.asarray(a)) for a in v[1:]])
            np.testing.assert_allclose(_canon(row_t, v[0]),
                                       _canon(row_j, v[0]), atol=2e-4)


@pytest.mark.parametrize("eval_mode", [False, True])
def test_fit_one_shape_matches_jax(fitters, eval_mode):
    """Dispatch, the guards (< 20 points, a spline under 100, an unknown
    label), the geometric batch and both spline kinds: as they are, and
    in eval mode (outliers removed, resampled to 1500 / 1800 points with
    JAX's draws)."""
    jf, tf = fitters
    segs = _segments()
    want = jdrv.fit_one_shape(segs, jf, eval_mode=eval_mode)
    got = tdrv.fit_one_shape(segs, tf, eval_mode=eval_mode)
    assert [k for k, v in got[0].items() if v is None] == [4, 5, 6]
    assert tuple(got[1][1].shape) == (930, 3)   # 30 x 30 + the wrapped row
    _hold_shape(got, want)


def test_fit_one_shape_refit_matches_jax(fitters):
    _, tf = fitters
    segs = _segments()[:2]
    got = tdrv.fit_one_shape(segs, tf, eval_mode=True, if_optimize=True)
    plain = tdrv.fit_one_shape(segs, tf, eval_mode=True)
    rng = np.random.RandomState(0)
    for seg, closed in zip(segs, (False, True)):
        w = np.ones(seg["points"].shape[0], np.float32) + 1e-8
        kept, keep = tdrv.remove_outliers(seg["points"], return_mask=True)
        pts, _ = tdrv.up_sample_points_in_range(
            kept, w[keep], 0, 1800 if closed else 1500, rng)
        want = jdrv.optimize_spline_kronecker(
            plain[1][seg["id"]].numpy(), pts, closed=closed)
        np.testing.assert_allclose(got[1][seg["id"]].numpy(), want,
                                   atol=1e-6)


def _eval_items(n_shapes=2):
    """Small synthetic shapes, each with one segment labelled a spline (an
    open one in the first, a closed one in the second), with their true
    labels as the clustering."""
    items = []
    for i in range(n_shapes):
        d = make_synthetic_shape(np.random.RandomState(30 + i),
                                 n_points=700, n_segments=4)
        prim = d["prim"].astype(np.int64).copy()
        seg = np.bincount(d["labels"]).argmax()
        prim[d["labels"] == seg] = 2 if i == 0 else 0
        items.append({"points": d["points"].astype(np.float32),
                      "normals": d["normals"].astype(np.float32),
                      "labels": d["labels"].astype(np.int64),
                      "cluster_ids": d["labels"].astype(np.int64),
                      "pred_primitives": prim})
    return items


def test_residual_eval_batch_and_coverage_match_jax(fitters):
    jf, tf = fitters
    items = _eval_items()
    got = tev.Evaluation(tf).residual_eval_batch(items)
    want = jev.Evaluation(jf).residual_eval_batch(items)
    assert len(got) == len(want) == 2
    names = set()
    for it, (gl, gp, gd), (wl, wp, wd) in zip(items, got, want):
        assert set(gd) == set(wd) and set(gp) == set(wp)
        for k in wd:
            assert gd[k][0] == wd[k][0]
            names.add(gd[k][0])
            np.testing.assert_allclose(float(gd[k][1]), float(wd[k][1]),
                                       rtol=1e-4)
        for g, w in zip(gl, wl):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_allclose(g, w, rtol=1e-4)
        cov_t = tev.p_coverage(it["points"], gp, device="cpu")
        cov_j = jev.p_coverage(it["points"], wp)
        np.testing.assert_allclose(cov_t[0], cov_j[0], rtol=1e-4)
        assert abs(cov_t[1] - cov_j[1]) <= 1.0 / len(it["points"])
    assert {"open-spline", "closed-spline"} <= names
    # one shape at a time gives the same as the batch
    one = tev.Evaluation(tf).residual_eval_mode(
        items[0]["points"], items[0]["normals"], items[0]["labels"],
        items[0]["cluster_ids"], items[0]["pred_primitives"])
    assert one[0] == got[0][0]


def test_residual_train_mode_and_helpers_match_jax(fitters):
    jf, tf = fitters
    rng = np.random.RandomState(40)
    d = make_synthetic_shape(rng, n_points=500, n_segments=3)
    labels = d["labels"].astype(np.int64)
    pred = labels.copy()
    pred[rng.rand(500) < 0.05] = 0
    pred[labels == 2] = 5                      # ids need not be 0..K-1
    oh_p = np.eye(50, dtype=np.float32)[pred][None]
    oh_g = np.eye(50, dtype=np.float32)[labels][None]
    np.testing.assert_array_equal(
        relaxed_iou_fast(torch.from_numpy(oh_p), torch.from_numpy(oh_g)),
        np.asarray(jax_relaxed_iou(jnp.asarray(oh_p), jnp.asarray(oh_g))))
    for a, b in zip(tev.match(labels, pred, device="cpu"),
                    jev.match(labels, pred)):
        np.testing.assert_array_equal(a, b)
    sims = rng.uniform(-1, 1, (6, 500)).astype(np.float32)
    for k in (1, 6):
        np.testing.assert_allclose(
            tev.weights_normalize(torch.from_numpy(sims[:k]), 0.3).numpy(),
            np.asarray(jev.weights_normalize(jnp.asarray(sims[:k]), 0.3)),
            rtol=1e-5, atol=1e-7)
    dist = {0: ["plane", 0.5], 1: ["open-spline", 2.0], 2: ["cone", 0.1],
            3: ["sphere", 0.2]}
    gt = {0: np.zeros((150, 3)), 1: np.zeros((300, 3)), 2: np.zeros((99, 3)),
          3: None}
    assert tev.separate_losses(dist, gt, lamb=0.5) == jev.separate_losses(
        dist, gt, lamb=0.5)

    weights = rng.uniform(0, 1, (6, 500)).astype(np.float32)
    got = tev.Evaluation(tf).residual_train_mode(
        d["points"].astype(np.float32), d["normals"].astype(np.float32),
        labels, pred, d["prim"].astype(np.int64), torch.from_numpy(weights),
        0.4)
    want = jev.Evaluation(jf).residual_train_mode(
        d["points"].astype(np.float32), d["normals"].astype(np.float32),
        labels, pred, d["prim"].astype(np.int64), jnp.asarray(weights), 0.4)
    assert set(got[2]) == set(want[2]) and got[2]
    for k in want[2]:
        assert got[2][k][0] == want[2][k][0]
        np.testing.assert_allclose(float(got[2][k][1]),
                                   float(want[2][k][1]), rtol=1e-4)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-4)
