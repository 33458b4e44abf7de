"""SplineNet's supervised trainer in the port (sednet_tpu_torch.splinenet_train,
losses/spline.py, chamfer's backward in ops/chamfer.py, utils/mesh.py)
against the JAX package's on the CPU, at grid 5, N 120, k 10, B 4.

Tolerances: the losses' values and gradients at rtol 1e-5; chamfer's
gradient at atol 1e-6; the patches exactly equal; `evaluate` and
eval_splinenet's three means at rtol 1e-5; one train step's metrics and
gradients, JAX's and the port's alike, within 1e-4 relative and 5e-3
relative L2 per leaf of the float64 step (the float32 step's conditioning,
at `METRIC_TOL`); its updated parameters (where the step's sign is
defined) and batch statistics within 1e-4 relative L2 per leaf of JAX's."""
import functools
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import sednet_tpu.splinenet_train as jst
import sednet_tpu_torch.splinenet_train as pst
from sednet_tpu.fit.bspline import uniform_knot_bspline
from sednet_tpu.losses import spline as jls
from sednet_tpu.models.splinenet import SplineNet as JaxSplineNet
from sednet_tpu.ops import chamfer as jch
from sednet_tpu.train import load_params as jax_load_params
from sednet_tpu.utils import mesh as jmesh
from sednet_tpu_torch.losses import spline as pls
from sednet_tpu_torch.ops import chamfer as pch
from sednet_tpu_torch.utils import mesh as pmesh
from sednet_tpu_torch.models import splinenet as tsn
from sednet_tpu_torch.weights import (flat_from_params, flat_from_splinenet,
                                      flatten_tree, splinenet_from_variables)

GRID, N, K, B = 5, 120, 10, 4
KINDS = ["open", "closed"]


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def both(jfn, pfn, args, argnum=0):
    """(JAX value, JAX gradient, port value, port gradient) of the first
    output of jfn / pfn in args[argnum]."""
    def first(*a):
        out = jfn(*a)
        return out[0] if isinstance(out, tuple) else out

    jv, jg = jax.value_and_grad(first, argnums=argnum)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    targs = [t(a, i == argnum) if isinstance(a, np.ndarray) else a
             for i, a in enumerate(args)]
    out = pfn(*targs)
    pv = out[0] if isinstance(out, tuple) else out
    pv.backward()
    return (float(jv), np.asarray(jg), float(pv.detach()),
            targs[argnum].grad.numpy())


def assert_value_grad(res, rtol=1e-5):
    jv, jg, pv, pg = res
    np.testing.assert_allclose(pv, jv, rtol=rtol)
    np.testing.assert_allclose(pg, jg, rtol=rtol, atol=1e-7)


# --- losses ----------------------------------------------------------------

def _grids(seed, b=B, g=GRID):
    rng = np.random.RandomState(seed)
    return (np.tanh(rng.randn(b, g * g, 3)).astype(np.float32),
            rng.randn(b, g, g, 3).astype(np.float32))


def test_permutations_match_jax():
    _, cp = _grids(0)
    np.testing.assert_array_equal(pls._all_permutations(t(cp)).numpy(),
                                  np.asarray(jls._all_permutations(cp)))
    np.testing.assert_array_equal(
        pls._all_permutations_half(t(cp)).numpy(),
        np.asarray(jls._all_permutations_half(cp)))


@pytest.mark.parametrize("closed", [False, True])
def test_permute_losses_match_jax(closed):
    out, cp = _grids(1 + closed)
    if closed:
        jfn = functools.partial(jls.control_points_permute_closed_loss,
                                grid_u=GRID, grid_v=GRID)
        pfn = functools.partial(pls.control_points_permute_closed_loss,
                                grid_u=GRID, grid_v=GRID)
    else:
        jfn = functools.partial(jls.control_points_permute_loss,
                                grid_size=GRID)
        pfn = functools.partial(pls.control_points_permute_loss,
                                grid_size=GRID)
    assert_value_grad(both(jfn, pfn, (out, cp)))
    np.testing.assert_array_equal(pfn(t(out), t(cp))[1].numpy(),
                                  np.asarray(jfn(out, cp)[1]))


# A ground truth symmetric under the first flip makes symmetries 0 and 1
# equal, and the prediction lies nearest to them: both sides gather the
# first and split the min's gradient over the two.
def test_permute_loss_tie_matches_jax():
    out, cp = _grids(3)
    cp = (cp + cp[:, ::-1]) / 2
    out = (cp.reshape(B, -1, 3) + 0.01 * np.tanh(out)).astype(np.float32)
    jfn = functools.partial(jls.control_points_permute_loss, grid_size=GRID)
    pfn = functools.partial(pls.control_points_permute_loss, grid_size=GRID)
    perms = np.asarray(jls._all_permutations(cp))
    diff = ((out.reshape(B, 1, GRID, GRID, 3) - perms) ** 2).sum((2, 3, 4))
    assert (diff[:, 0] == diff[:, 1]).all() and (diff.argmin(1) == 0).all()
    assert_value_grad(both(jfn, pfn, (out, cp)))
    np.testing.assert_array_equal(pfn(t(out), t(cp))[1].numpy(),
                                  np.asarray(jfn(out, cp)[1]))


def _surface_inputs(seed, g=GRID, n=N):
    rng = np.random.RandomState(seed)
    nu, nv = uniform_knot_bspline(g, g, 3, 3, 30)
    control = np.tanh(rng.randn(B, g * g, 3)).astype(np.float32)
    points = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    return nu, nv, control, points


@pytest.mark.parametrize("sqrt", [False, True])
def test_reconstruction_loss_matches_jax(sqrt):
    nu, nv, control, points = _surface_inputs(4)
    res = both(
        lambda c, p: jls.spline_reconstruction_loss(nu, nv, c, p, sqrt=sqrt),
        lambda c, p: pls.spline_reconstruction_loss(nu, nv, c, p, sqrt=sqrt),
        (control, points))
    assert_value_grad(res)


@pytest.mark.parametrize("side", [0, 1])
def test_one_sided_loss_matches_jax(side):
    nu, nv, control, points = _surface_inputs(5)
    assert_value_grad(both(
        lambda c, p: jls.spline_reconstruction_loss_one_sided(
            nu, nv, c, p, side=side),
        lambda c, p: pls.spline_reconstruction_loss_one_sided(
            nu, nv, c, p, side=side), (control, points)))


@pytest.mark.parametrize("dist_type", ["l2", "l1"])
def test_laplacian_loss_matches_jax(dist_type):
    out, gt = _grids(6)
    out = out.reshape(B, GRID, GRID, 3)
    assert_value_grad(both(
        functools.partial(jls.laplacian_loss, dist_type=dist_type),
        functools.partial(pls.laplacian_loss, dist_type=dist_type),
        (out, gt)))


# chamfer's custom backward against jax.grad through JAX's custom VJP, at
# the loss's shapes cut down: weighted d1 and d2, gradients in x and y
def test_chamfer_backward_matches_jax_vjp():
    rng = np.random.RandomState(7)
    x = rng.randn(B, 90, 3).astype(np.float32)
    y = rng.randn(B, N, 3).astype(np.float32)
    w1, w2 = rng.rand(B, 90).astype(np.float32), rng.rand(B, N).astype(
        np.float32)

    def jloss(a, b):
        d1, d2 = jch.chamfer_index(a, b)
        return (w1 * d1).sum() + (w2 * d2).sum()

    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x, True), t(y, True)
    d1, d2 = pch.chamfer_index(tx, ty)
    ((t(w1) * d1).sum() + (t(w2) * d2).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=1e-6)
    # the metric's forward is unchanged, and sqrt's gradient flows too
    tx.grad = None
    pch.chamfer_distance(tx, ty, sqrt=True).backward()
    jg = jax.grad(lambda a: jch.chamfer_distance(a, jnp.asarray(y),
                                                 sqrt=True))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_mesh_helpers_match_jax():
    pts = np.random.RandomState(8).randn(12, 3)
    v, f = pmesh.tessellate_points(pts, 4, 3)
    jv, jf = jmesh.tessellate_points(pts, 4, 3)
    np.testing.assert_array_equal(v, jv)
    assert f == jf
    np.testing.assert_array_equal(pmesh.grid_pointclouds([pts, pts], cols=1),
                                  jmesh.grid_pointclouds([pts, pts], cols=1))


# --- data ------------------------------------------------------------------

@pytest.fixture(scope="module")
def h5s(tmp_path_factory):
    """JAX's spline h5 files, open and closed, 6 patches of N points."""
    root = tmp_path_factory.mktemp("splines")
    out = {}
    for kind in KINDS:
        out[kind] = jst.write_spline_h5(str(root / f"{kind}.h5"),
                                        n_patches=6, n_points=N, grid=GRID,
                                        closed=kind == "closed")
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_patches_equal_jax_h5(h5s, tmp_path, kind):
    want = jst.load_spline_h5(h5s[kind])
    got = pst.make_spline_patches(n_patches=6, n_points=N, grid=GRID,
                                  closed=kind == "closed")
    path = pst.write_spline_h5(str(tmp_path / "p.h5"), n_patches=6,
                               n_points=N, grid=GRID, closed=kind == "closed")
    for a, b, c in zip(got, want, pst.load_spline_h5(path)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


# --- one train step ----------------------------------------------------------

def _record_grads():
    """A transformation that keeps the gradients in its state and passes
    them on, so that JAX's own step gives them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    return jax.device_get(jax.jit(JaxSplineNet(GRID, K).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, N, 3))))


def jax_variables(seed):
    """JAX's initial SplineNet variables (fresh numpy copies)."""
    variables = jax.tree.map(np.array, _jax_init(seed))
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}


def port_step(flat0, points, ctrl, closed, dtype, replay=None):
    """One port train step in dtype from the variables flat0; the kNN
    graphs recorded, or replayed from `replay`. Returns (metrics, the
    gradients in the flax layout, the updated variables, the graphs)."""
    nu, nv = (a.astype(np.float64 if dtype == torch.float64 else np.float32)
              for a in uniform_knot_bspline(GRID, GRID, 3, 3, 30))
    model = splinenet_from_variables(flat0, GRID, K, device="cpu").to(dtype)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)
    step, _ = pst.make_spline_train_step(model, optimizer, nu, nv,
                                         closed=closed, loss_weight=0.9,
                                         grid=GRID)
    graphs, real = [], tsn.knn_indices

    def knn(x, k):
        graphs.append(replay[len(graphs)] if replay else real(x, k))
        return graphs[-1]

    tsn.knn_indices = knn
    try:
        metrics = step(t(points).to(dtype), t(ctrl).to(dtype))
    finally:
        tsn.knn_indices = real
    grads = {"params/" + k: v.astype(np.float64) for k, v in
             flat_from_params({n: p.grad.double() for n, p in
                               model.named_parameters()}).items()}
    new = {k: v.astype(np.float64)
           for k, v in flat_from_splinenet(model.float()).items()}
    return ({k: float(v) for k, v in metrics.items()}, grads, new, graphs)


@pytest.fixture(scope="module")
def step_pairs(h5s):
    """One step of JAX's `make_spline_train_step` (optax.adam behind the
    gradient recorder) and of the port's, from JAX's init variables, on
    the first B patches of each kind; the port's step also in float64 on
    the float32 step's graphs (`exact`); and both sides' `evaluate` on
    the init variables and the other patches."""
    out = {}
    nu, nv = uniform_knot_bspline(GRID, GRID, 3, 3, 30)
    for kind in KINDS:
        closed = kind == "closed"
        points, ctrl = jst.load_spline_h5(h5s[kind])
        variables = jax_variables(1 + closed)
        flat0 = flatten_tree(variables)
        opt = optax.chain(_record_grads(), optax.adam(1e-3))
        state = jst.SplineTrainState(variables, opt.init(variables["params"]),
                                     jnp.int32(0))
        step, evaluate = jst.make_spline_train_step(
            JaxSplineNet(GRID, K), opt, nu, nv, closed=closed,
            loss_weight=0.9, grid=GRID)
        new, jm = step(state, jnp.asarray(points[:B]), jnp.asarray(ctrl[:B]))
        jax_run = ({k: float(v) for k, v in jm.items()},
                   flatten_tree({"params": jax.device_get(new.opt_state[0])}),
                   flatten_tree(jax.device_get(new.variables)))
        port = port_step(flat0, points[:B], ctrl[:B], closed, torch.float32)
        exact = port_step(flat0, points[:B], ctrl[:B], closed, torch.float64,
                          replay=port[3])
        model = splinenet_from_variables(flat0, GRID, K, device="cpu")
        _, tevaluate = pst.make_spline_train_step(
            model, torch.optim.Adam(model.parameters()), nu, nv,
            closed=closed, loss_weight=0.9, grid=GRID)
        out[kind] = dict(jax=jax_run, port=port[:3], exact=exact[:3],
                         jev=evaluate(variables, jnp.asarray(points[B:]),
                                      jnp.asarray(ctrl[B:])),
                         tev=tevaluate(t(points[B:]), t(ctrl[B:])))
    return out


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# The step is ill-conditioned in float32: bn6 and bn7 normalise (4, 1024)
# features over the batch of 4, where some channels' 4 values lie close
# together, so an input's rounding (1e-6 of its size) comes out up to 1e-3
# of the normalised value's. Each side's float32 step therefore lies up to
# about 2e-5 (metrics) and 1e-3 relative L2 (gradients) from the float64
# step on the same graphs, whatever the order of its sums: rtol 1e-5
# between two float32 steps is below what either can give. So both are
# held to the port's float64 step (`exact`) within the TOL below: JAX's
# (which fails if the port's arithmetic were another function) and the
# port's.
METRIC_TOL, GRAD_TOL = 1e-4, 5e-3


def _held(port, jax_, exact, tol, err):
    for side, value in (("JAX", jax_), ("port", port)):
        assert err(value, exact) <= tol, (side, err(value, exact))


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_metrics_match_jax(step_pairs, kind):
    p = step_pairs[kind]
    for name in ("loss", "l_reg", "cd", "lap"):
        _held(p["port"][0][name], p["jax"][0][name], p["exact"][0][name],
              METRIC_TOL, lambda a, b: abs(a - b) / abs(b))
    for name in ("l_reg", "cd"):
        np.testing.assert_allclose(float(p["tev"][name]),
                                   float(p["jev"][name]), rtol=1e-5,
                                   err_msg=name)


def _live(exact):
    """The gradient leaves that are not 0 in exact arithmetic: the biases
    of conv6 and conv7 and of bn5 feed a train-mode BatchNorm over the
    batch, which removes any shift, so their float64 gradients are
    rounding noise (about 1e-16 of the others)."""
    total = np.sqrt(sum(float(np.sum(g * g)) for g in exact.values()))
    return {k for k, g in exact.items() if np.linalg.norm(g) > 1e-9 * total}


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_gradients_match_jax(step_pairs, kind):
    p = step_pairs[kind]
    jg, pg, eg = p["jax"][1], p["port"][1], p["exact"][1]
    assert jg.keys() == pg.keys() == eg.keys() and len(jg) == 25
    live = _live(eg)
    assert sorted(set(eg) - live) == ["params/bn5/bias", "params/conv6/bias",
                                      "params/conv7/bias"]
    total = np.sqrt(sum(float(np.sum(g * g)) for g in eg.values()))
    for key in eg:
        if key in live:
            _held(pg[key], jg[key], eg[key], GRAD_TOL, rel_l2)
        else:   # rounding noise on both sides
            for g in (jg[key], pg[key]):
                assert np.linalg.norm(g) <= 1e-5 * total, key


# Adam's first step moves each parameter by about lr * sign(g): compared
# per leaf (relative L2) on the elements whose float64 gradient stands
# clear of both sides' float32 error, where the sign is defined; every
# element moved by at most lr on both sides. The running statistics
# within 1e-4 relative L2 per leaf.
@pytest.mark.parametrize("kind", KINDS)
def test_train_step_update_matches_jax(step_pairs, kind):
    p = step_pairs[kind]
    (_, jg, jnew), (_, pg, pnew), (_, eg, _) = p["jax"], p["port"], p["exact"]
    old = flatten_tree(jax_variables(1 + (kind == "closed")))
    assert jnew.keys() == pnew.keys() == old.keys()
    for key in jnew:
        if key.startswith("batch_stats/"):
            assert rel_l2(pnew[key], jnew[key]) <= 1e-4, key
            continue
        for new in (jnew[key], pnew[key]):
            # lr, and the float32 rounding of a parameter near 1
            assert np.abs(new - old[key]).max() <= 1e-3 + 1.2e-7, key
        if key not in _live(eg):
            continue
        noise = np.maximum(np.abs(jg[key] - eg[key]), np.abs(pg[key] - eg[key]))
        sure = np.abs(eg[key]) > 10 * noise
        assert sure.mean() > 0.9, key
        assert rel_l2(pnew[key][sure], jnew[key][sure]) <= 1e-4, key


# --- eval_splinenet, train_splinenet, the CLI ----------------------------------

def seeded_variables(seed):
    """JAX init variables with the BatchNorm statistics, scales and biases
    redrawn from seed, so that eval mode's running statistics matter."""
    flat = flatten_tree(jax_variables(seed))
    rng = np.random.RandomState(seed)
    for name in sorted(flat):
        shape = flat[name].shape
        if name.endswith("/mean"):
            flat[name] = (rng.randn(*shape) * 0.1).astype(np.float32)
        elif name.endswith("/var"):
            flat[name] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif name.endswith("/scale"):
            flat[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return flat


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


@pytest.mark.parametrize("kind", KINDS)
def test_eval_splinenet_on_jax_orbax_matches_jax(h5s, tmp_path, kind):
    ckpt = str(tmp_path / kind)
    ocp.PyTreeCheckpointer().save(ckpt, unflatten(seeded_variables(5)))
    kw = dict(ckpt=ckpt, data_path=h5s[kind], closed=kind == "closed",
              grid=GRID, k=K, batch_size=B, num_points=100,
              test_fraction=0.5, save_meshes=True)
    want = jst.eval_splinenet(out_dir=str(tmp_path / "jax"), **kw)
    got = pst.eval_splinenet(out_dir=str(tmp_path / "port"), device="cpu",
                             **kw)
    assert got["n_shapes"] == want["n_shapes"] == 3
    for name in ("test_reg", "test_cd", "test_lap"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files and len(files) == 9
    for name in files:
        a, b = (str(tmp_path / side / name) for side in ("port", "jax"))
        if name.endswith(".txt"):
            assert open(a).read() == open(b).read(), name
        else:
            va, vb = (np.array([ln.split()[1:] for ln in open(f)
                                if ln.startswith("v ")], float)
                      for f in (a, b))
            np.testing.assert_allclose(va, vb, atol=1e-5, err_msg=name)
            fa, fb = ([ln for ln in open(f) if ln.startswith("f ")]
                      for f in (a, b))
            assert fa == fb, name


# train_splinenet from JAX's initial variables: the history's records and
# the saved variables, which JAX's load_params reads
def test_train_splinenet_history_and_checkpoint(h5s, tmp_path):
    flat = flatten_tree(jax_variables(1))
    run = str(tmp_path / "run")
    _, history = pst.train_splinenet(
        data_path=h5s["open"], grid=GRID, k=K, batch_size=B, steps=3,
        eval_every=2, run_dir=run, device="cpu",
        model=splinenet_from_variables(flat, GRID, K, device="cpu"))
    assert [r["step"] for r in history] == [2, 3]
    for rec in history:
        assert set(rec) == {"step", "loss", "l_reg", "cd", "lap", "ts_l_reg",
                            "ts_cd"}
        assert all(np.isfinite(v) for v in rec.values())
    with open(os.path.join(run, "history.json")) as f:
        assert json.load(f) == history
    saved = jax_load_params(os.path.join(run, "open.npz"))
    assert set(saved) == {"params", "batch_stats"}
    assert flatten_tree(saved).keys() == flat.keys()
    model = pst.load_spline_variables(os.path.join(run, "open.npz"), GRID, K,
                                      device="cpu")
    assert not torch.equal(model.conv8.weight,
                           torch.from_numpy(flat["params/conv8/kernel"].T))


MAINS = {
    "train": ["closed", "--data", "D.h5", "--steps", "2", "--grid", "5",
              "--k", "10", "--batch-size", "4", "--lr", "0.002",
              "--loss-weight", "0.8", "--run-dir", "R"],
    "eval": ["eval", "open", "--ckpt", "C", "--data", "D.h5", "--grid", "5",
             "--k", "10", "--batch-size", "2", "--num-points", "100",
             "--out-dir", "O", "--save-meshes"],
    "dump": ["dump", "cfg.json", "--data-root", "ROOT", "--out", "P.h5",
             "--limit", "2"],
}
ENTRY = {"train": "train_splinenet", "eval": "eval_splinenet",
         "dump": "dump_predictions"}


# main's three subcommands pass JAX's flags to the same entry with the
# same arguments
@pytest.mark.parametrize("sub", list(MAINS))
def test_main_passes_jax_flags(sub, monkeypatch):
    calls = {}
    for side, mod in (("jax", jst), ("port", pst)):
        monkeypatch.setattr(mod, ENTRY[sub], lambda *a, side=side, **kw:
                            calls.__setitem__(side, (a, kw)))
        mod.main(list(MAINS[sub]))
    assert calls["port"] == calls["jax"]


# main driven for real on the CPU: train, then eval of the checkpoint it
# wrote, then the dump of a segmentation model's predictions
def test_main_drives_train_eval_and_dump(h5s, tmp_path, monkeypatch):
    import sednet_tpu_torch.config as pcfg
    import sednet_tpu_torch.data as data_port
    from sednet_tpu.train import build_model, save_params_npz

    for name in ENTRY.values():
        monkeypatch.setattr(pst, name, functools.partial(getattr(pst, name),
                                                         device="cpu"))
    run, out = str(tmp_path / "run"), str(tmp_path / "out")
    pst.main(["open", "--data", h5s["open"], "--steps", "2", "--grid", "5",
              "--k", "10", "--batch-size", "4", "--run-dir", run])
    assert len(json.load(open(os.path.join(run, "history.json")))) == 1
    pst.main(["eval", "open", "--ckpt", os.path.join(run, "open.npz"),
              "--data", h5s["open"], "--grid", "5", "--k", "10",
              "--num-points", "120", "--out-dir", out, "--save-meshes"])
    assert os.path.exists(os.path.join(out, "pred_0.obj"))

    root, n = str(tmp_path / "data"), 100
    data_port.write_parsenet_h5(root, n_shapes=3, n_points=n)
    cfg = pcfg.Config(num_points=n, knn=4, embed=16, hpnet_embed=False,
                      ms_num_samples=n, edge_topk=16, num_test=3)
    ckpt = str(tmp_path / "sednet.npz")
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0),
                                            jnp.zeros((1, n, 6)))["params"]
    save_params_npz(ckpt, params)
    cfg.pretrain_model_path = cfg.pretrain_model_type_path = ckpt
    cfg.save(str(tmp_path / "cfg.json"))
    pred = str(tmp_path / "pred" / "predictions.h5")
    pst.main(["dump", str(tmp_path / "cfg.json"), "--data-root", root,
              "--out", pred])
    with h5py.File(pred) as hf:
        assert hf["seg_id"].shape == hf["prim"].shape == (3, n)
