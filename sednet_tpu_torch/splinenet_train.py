"""SplineNet training: supervised regression of the control grid.

Counterpart of `sednet_tpu/splinenet_train.py` (reference:
Fitting_patches_and_edges/splinenet/train_open_splines.py and
train_closed_control_points.py):

  loss = loss_weight * the control grid's regression, invariant to the
         grid's symmetries (rolls too for closed splines)
         + (1 - loss_weight) * (one-sided reconstruction chamfer + Laplacian)
  (train_open_splines.py:169-188), SplineNet in train mode (flax's
  BatchNorm, its running statistics updated by the step), optax.adam's
  update as torch's Adam (b1 0.9, b2 0.999, eps 1e-8).

Data: spline patches with their ground-truth control grids, the reference's
DataSetControlPointsPoisson schema (points (S, N, 3), controlpoints
(S, g, g, 3)). `make_spline_patches` draws them from seeded random control
grids (numpy only; the same RandomState draws as JAX's `write_spline_h5`),
`write_spline_h5` / `load_spline_h5` keep them in h5 files (h5py,
imported when called).

What differs from JAX, by design: the initial weights come from
`models.init.init_like_flax` (flax's distributions, another generator),
and the trained variables are saved as one flat `.npz`
(`<run_dir>/open.npz` or `closed.npz`, "params/..." and "batch_stats/..."),
which JAX's `load_params` and `weights.splinenet_from_variables` read; no
orbax directory is written. `eval_splinenet` reads that file or JAX's
orbax directory.

Every SplineNet forward builds four kNN graphs, kernel K1 on the card.

CLI: python -m sednet_tpu_torch.splinenet_train {open|closed} --data FILE
     python -m sednet_tpu_torch.splinenet_train eval {open|closed}
         --ckpt PATH --data FILE [--save-meshes --out-dir D]
     python -m sednet_tpu_torch.splinenet_train dump CONFIG [--out H5]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import NamedTuple

import numpy as np
import torch

from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.fit.bspline import (sample_from_control_grid,
                                          uniform_knot_bspline)
from sednet_tpu_torch.losses.spline import (
    control_points_permute_closed_loss, control_points_permute_loss,
    laplacian_loss, spline_reconstruction_loss,
    spline_reconstruction_loss_one_sided)
from sednet_tpu_torch.models.init import init_like_flax
from sednet_tpu_torch.models.splinenet import SplineNet
from sednet_tpu_torch.weights import (flat_from_splinenet, flatten_tree,
                                      read_orbax_tree,
                                      splinenet_from_variables)

logger = logging.getLogger("sednet_tpu_torch.splinenet_train")


def _import_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the spline patches' h5 files need the h5py "
                          "package; make_spline_patches gives the arrays "
                          "without it") from e
    return h5py


def _poisson_like_select(surf: np.ndarray, n_points: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """Blue-noise selection by farthest-point sampling (the evenly spaced
    Poisson-disk samples of the reference's spline h5); with-replacement
    choice when the surface has fewer samples than requested."""
    m = surf.shape[0]
    if m < n_points:
        return rng.choice(m, n_points, replace=True)
    sel = np.empty(n_points, np.int64)
    sel[0] = rng.randint(m)
    d = ((surf - surf[sel[0]]) ** 2).sum(1)
    for i in range(1, n_points):
        sel[i] = int(np.argmax(d))
        d = np.minimum(d, ((surf - surf[sel[i]]) ** 2).sum(1))
    return sel


def _sample_surface(nu, nv, ctrl):
    """The surface of one control grid (g, g, 3) in float32, contracted in
    the order of JAX's einsum (u first, then v)."""
    g = ctrl.shape[0]
    ctrl = ctrl.astype(np.float32)
    t = ctrl.reshape(g, -1).T @ nu.T                     # (v*c, gu)
    t = t.reshape(g, -1).T @ nv.T                        # (c*gu, gv)
    return t.reshape(3, nu.shape[0], nv.shape[0]).transpose(1, 2, 0) \
        .reshape(-1, 3)


def make_spline_patches(*, n_patches=32, n_points=700, grid=20, seed=0,
                        closed=False):
    """Synthetic spline patches: a (grid x grid) control grid of a bumpy
    sheet (closed: a bumpy tube), the surface sampled on the 40 x 40
    uniform-knot grid, n_points of it by farthest-point sampling plus noise
    0.005. Returns (points (S, n_points, 3), ctrl (S, g, g, 3)), float32,
    from the RandomState draws of `sednet_tpu/splinenet_train.py:73
    write_spline_h5`: its arrays bit for bit at small grids (grid 5). At
    grid 20 the surface's float32 sums round otherwise than XLA's (2.4e-7
    at most), and the farthest-point sampling, whose regular 40 x 40 grid
    of samples holds many equal distances, then breaks some ties the
    other way: the same grids, other points of the same surfaces."""
    rng = np.random.RandomState(seed)
    nu, nv = uniform_knot_bspline(grid, grid, 3, 3, 40)
    ctrls, points = [], []
    for _ in range(n_patches):
        u, v = np.meshgrid(np.linspace(-1, 1, grid), np.linspace(-1, 1, grid))
        bumps = 0.3 * rng.randn(4, 4)
        z = sum(b[0] * np.sin(b[1] * u + b[2] * v + b[3]) for b in bumps)
        ctrl = np.stack([u, v, 0.3 * z], -1).astype(np.float32)
        if closed:
            theta = (u + 1) * np.pi
            r = 0.5 + 0.15 * z
            ctrl = np.stack([r * np.cos(theta), r * np.sin(theta), v], -1)
        surf = _sample_surface(nu, nv, ctrl)
        sel = _poisson_like_select(surf, n_points, rng)
        points.append(surf[sel] + 0.005 * rng.randn(n_points, 3))
        ctrls.append(ctrl)
    return (np.stack(points).astype(np.float32),
            np.stack(ctrls).astype(np.float32))


def write_spline_h5(path: str, **kw):
    """`make_spline_patches(**kw)` written to an h5 file in the reference's
    schema ("points", "controlpoints"). Returns path."""
    h5py = _import_h5py()
    points, ctrl = make_spline_patches(**kw)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("points", data=points)
        hf.create_dataset("controlpoints", data=ctrl)
    return path


def load_spline_h5(path: str):
    """(points, controlpoints) of a spline h5 file, as numpy arrays."""
    h5py = _import_h5py()
    with h5py.File(path, "r") as hf:
        return np.array(hf["points"]), np.array(hf["controlpoints"])


class SplineTrainState(NamedTuple):
    model: SplineNet
    optimizer: torch.optim.Optimizer
    step: int


def _regression(closed: bool, ctrl, gt_ctrl, grid: int):
    if closed:
        return control_points_permute_closed_loss(ctrl, gt_ctrl, grid, grid)
    return control_points_permute_loss(ctrl, gt_ctrl, grid)


def make_spline_train_step(model: SplineNet, optimizer, nu, nv, *,
                           closed: bool, loss_weight: float, grid: int):
    """(step, evaluate). step(points, gt_ctrl) -> metrics: one Adam step of
    the model's parameters on the loss of the module's docstring, in train
    mode (the BatchNorm running statistics updated); metrics `loss`,
    `l_reg`, `cd`, `lap` as 0-d tensors. evaluate(points, gt_ctrl) ->
    {`l_reg`, `cd`} in eval mode, under no gradient. Tensors on the
    model's device."""
    device = next(model.parameters()).device
    nu_t = torch.as_tensor(nu, device=device)
    nv_t = torch.as_tensor(nv, device=device)

    def step(points, gt_ctrl):
        optimizer.zero_grad(set_to_none=True)
        ctrl = model(points, train=True)
        l_reg, permuted = _regression(closed, ctrl, gt_ctrl, grid)
        cd, _ = spline_reconstruction_loss_one_sided(nu_t, nv_t, ctrl, points)
        lap = laplacian_loss(ctrl.reshape(-1, grid, grid, 3), permuted)
        total = l_reg * loss_weight + (cd + lap) * (1.0 - loss_weight)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "l_reg": l_reg.detach(),
                "cd": cd.detach(), "lap": lap.detach()}

    @torch.no_grad()
    def evaluate(points, gt_ctrl):
        ctrl = model(points, train=False)
        l_reg, _ = _regression(closed, ctrl, gt_ctrl, grid)
        cd, _ = spline_reconstruction_loss_one_sided(nu_t, nv_t, ctrl, points)
        return {"l_reg": l_reg, "cd": cd}

    return step, evaluate


def train_spline_arrays(points, ctrl, *, closed=False, grid=20, k=10,
                        batch_size=4, lr=1e-3, loss_weight=0.9, steps=100,
                        eval_every=50, run_dir="trains/splinenet", seed=0,
                        model: SplineNet | None = None, device=None):
    """The loop of `sednet_tpu/splinenet_train.py:161 train_splinenet` over
    arrays (points (S, N, 3), ctrl (S, g, g, 3)): the first 90% trains, the
    rest is the test split; each step takes batch_size patches drawn by
    RandomState(seed) as JAX draws them; every eval_every steps and at the
    last the metrics and the test split's (`ts_` prefix) go into the
    history. model: the SplineNet to train (default: `init_like_flax`
    seeded with seed). Saves `<run_dir>/{open|closed}.npz` and
    `<run_dir>/history.json`. On the card unless device says otherwise.
    Returns (SplineTrainState, history)."""
    dev = resolve_device(device)
    n = points.shape[0]
    n_train = max(int(n * 0.9), 1)
    os.makedirs(run_dir, exist_ok=True)
    if model is None:
        model = init_like_flax(SplineNet(grid_size=grid, k=k),
                               torch.Generator().manual_seed(seed))
    model.to(dev)
    nu, nv = uniform_knot_bspline(grid, grid, 3, 3, 30)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    step_fn, eval_fn = make_spline_train_step(
        model, optimizer, nu, nv, closed=closed, loss_weight=loss_weight,
        grid=grid)
    pts_t = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    ctrl_t = torch.from_numpy(np.asarray(ctrl, np.float32)).to(dev)

    rng = np.random.RandomState(seed)
    history = []
    for it in range(steps):
        sel = torch.from_numpy(rng.choice(n_train, batch_size,
                                          replace=n_train < batch_size))
        sel = sel.to(dev)
        metrics = step_fn(pts_t[sel], ctrl_t[sel])
        if (it + 1) % eval_every == 0 or it + 1 == steps:
            ev = (eval_fn(pts_t[n_train:], ctrl_t[n_train:]) if n > n_train
                  else {k2: float("nan") for k2 in ("l_reg", "cd")})
            rec = {"step": it + 1,
                   **{k2: float(v) for k2, v in metrics.items()},
                   **{"ts_" + k2: float(v) for k2, v in ev.items()}}
            history.append(rec)
            logger.info("%s", rec)
    np.savez_compressed(os.path.join(run_dir, ("closed" if closed
                                               else "open") + ".npz"),
                        **flat_from_splinenet(model))
    with open(os.path.join(run_dir, "history.json"), "w") as f:
        json.dump(history, f)
    return SplineTrainState(model, optimizer, steps), history


def train_splinenet(*, data_path: str, **kw):
    """`train_spline_arrays` over the patches of the h5 file at data_path
    (`load_spline_h5`), with the same keywords and defaults as JAX's
    `train_splinenet`: grid 20, k 10, batch 4, lr 1e-3, loss_weight 0.9."""
    points, ctrl = load_spline_h5(data_path)
    return train_spline_arrays(points, ctrl, **kw)


def load_spline_variables(ckpt: str, grid: int = 20, k: int = 10,
                          device=None) -> SplineNet:
    """A SplineNet in eval mode from a trained checkpoint: the port's flat
    `.npz`, or JAX's orbax directory of the variables."""
    if ckpt.endswith(".npz"):
        with np.load(ckpt) as f:
            flat = {key: f[key] for key in f.files}
    else:
        flat = flatten_tree(read_orbax_tree(ckpt))
    return splinenet_from_variables(flat, grid, k, device)


def eval_splinenet(*, ckpt: str, data_path: str, closed=False, grid=20,
                   k=10, batch_size=4, num_points=700, test_fraction=0.1,
                   out_dir: str | None = None, save_meshes=False, seed=0,
                   device=None):
    """The trained checkpoint's evaluation of `sednet_tpu/splinenet_train.py
    :208 eval_splinenet` (reference: splinenet/test_open_splines.py:85-211):
    over the test split (everything when the split is empty), in batches,
    each shape's points shuffled and cut to num_points by RandomState(seed):
    the means of test_reg (the invariant regression), test_cd (two-sided
    chamfer of roots between the sampled surface and the points) and
    test_lap. save_meshes writes, for each shape, the tessellated predicted
    and true surfaces as OBJ and the points as txt into out_dir. On the
    card unless device says otherwise."""
    from sednet_tpu_torch.postproc.arg2mesh import save_obj
    from sednet_tpu_torch.utils.mesh import tessellate_points

    dev = resolve_device(device)
    points, ctrl = load_spline_h5(data_path)
    n = points.shape[0]
    n_train = max(int(n * (1 - test_fraction)), 1)
    pts_test, ctrl_test = points[n_train:], ctrl[n_train:]
    if pts_test.shape[0] == 0:
        pts_test, ctrl_test = points, ctrl

    model = load_spline_variables(ckpt, grid, k, dev)
    nu, nv = (torch.from_numpy(a).to(dev)
              for a in uniform_knot_bspline(grid, grid, 3, 3, 30))
    rng = np.random.RandomState(seed)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    test_reg, test_cd, test_lap = [], [], []
    m = pts_test.shape[0]
    with torch.no_grad():
        for b0 in range(0, m, batch_size):
            pts_b = pts_test[b0:b0 + batch_size]
            ctrl_b = torch.from_numpy(ctrl_test[b0:b0 + batch_size]).to(dev)
            # the reference shuffles and cuts the input to num_points
            # (test_open_splines.py:105-108)
            sel = rng.permutation(pts_b.shape[1])[:min(num_points,
                                                       pts_b.shape[1])]
            x = torch.from_numpy(np.ascontiguousarray(pts_b[:, sel])).to(dev)
            ctrl_pred = model(x)
            cd, reconst = spline_reconstruction_loss(nu, nv, ctrl_pred, x,
                                                     sqrt=True)
            l_reg, permuted = _regression(closed, ctrl_pred, ctrl_b, grid)
            lap = laplacian_loss(ctrl_pred.reshape(-1, grid, grid, 3),
                                 permuted)
            test_reg.append(float(l_reg))
            test_cd.append(float(cd))
            test_lap.append(float(lap))
            if save_meshes and out_dir:
                gt_surf = sample_from_control_grid(
                    nu, nv, ctrl_b.reshape(-1, grid * grid, 3), grid,
                    grid).cpu().numpy()
                reconst = reconst.cpu().numpy()
                for bi in range(pts_b.shape[0]):
                    sid = b0 + bi
                    v, f = tessellate_points(reconst[bi], 30, 30)
                    save_obj(os.path.join(out_dir, f"pred_{sid}.obj"), v, f)
                    v, f = tessellate_points(gt_surf[bi], 30, 30)
                    save_obj(os.path.join(out_dir, f"gt_{sid}.obj"), v, f)
                    np.savetxt(os.path.join(out_dir, f"gt_points_{sid}.txt"),
                               pts_b[bi], fmt="%0.4f", delimiter=";")
    results = {"test_reg": float(np.mean(test_reg)),
               "test_cd": float(np.mean(test_cd)),
               "test_lap": float(np.mean(test_lap)),
               "n_shapes": int(m)}
    logger.info("Test Reg Loss: %(test_reg)s, Test CD Loss: %(test_cd)s, "
                "Test Lap: %(test_lap)s", results)
    print(json.dumps(results))
    return results


def dump_predictions(config_path: str, *, data_root=".", out_path=None,
                     limit=None, device=None):
    """The prediction dump of `sednet_tpu/splinenet_train.py:288`
    (reference: splinenet/generate_predictions.py:125-164): the port's
    `run_prediction` over the test split, packed into an h5 file
    {seg_id (S, N), prim (S, N)} (default predictions.h5)."""
    from sednet_tpu_torch.config import load_config
    from sednet_tpu_torch.predict import run_prediction

    h5py = _import_h5py()
    cfg = load_config(config_path)
    summary, metrics = run_prediction(cfg, data_root=data_root,
                                      save_viz=False, limit=limit,
                                      device=device)
    seg = np.stack([m["cluster_ids"] for m in metrics])
    prim = np.stack([m["pred_primitives"] for m in metrics])
    out_path = out_path or "predictions.h5"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with h5py.File(out_path, "w") as hf:
        hf.create_dataset("seg_id", data=seg.astype(np.int32))
        hf.create_dataset("prim", data=prim.astype(np.int32))
    logger.info("wrote %s: %s shapes, summary %s", out_path, seg.shape[0],
                summary)
    return out_path, summary


def main(argv=None):
    """The three subcommands of `sednet_tpu/splinenet_train.py main`, with
    its flags: train (open|closed), eval, dump."""
    import sys

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "eval":
        p = argparse.ArgumentParser(prog="splinenet_train eval")
        p.add_argument("kind", choices=["open", "closed"])
        p.add_argument("--ckpt", required=True)
        p.add_argument("--data", required=True)
        p.add_argument("--grid", type=int, default=20)
        p.add_argument("--k", type=int, default=10)
        p.add_argument("--batch-size", type=int, default=4)
        p.add_argument("--num-points", type=int, default=700)
        p.add_argument("--out-dir", default=None)
        p.add_argument("--save-meshes", action="store_true")
        a = p.parse_args(argv[1:])
        eval_splinenet(ckpt=a.ckpt, data_path=a.data,
                       closed=a.kind == "closed", grid=a.grid, k=a.k,
                       batch_size=a.batch_size, num_points=a.num_points,
                       out_dir=a.out_dir, save_meshes=a.save_meshes)
        return
    if argv and argv[0] == "dump":
        p = argparse.ArgumentParser(prog="splinenet_train dump")
        p.add_argument("config")
        p.add_argument("--data-root", default=".")
        p.add_argument("--out", default="predictions.h5")
        p.add_argument("--limit", type=int, default=None)
        a = p.parse_args(argv[1:])
        dump_predictions(a.config, data_root=a.data_root, out_path=a.out,
                         limit=a.limit)
        return
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=["open", "closed"])
    p.add_argument("--data", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--grid", type=int, default=20)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--loss-weight", type=float, default=0.9)
    p.add_argument("--run-dir", default="trains/splinenet")
    a = p.parse_args(argv)
    train_splinenet(data_path=a.data, closed=a.kind == "closed",
                    grid=a.grid, k=a.k, batch_size=a.batch_size, lr=a.lr,
                    loss_weight=a.loss_weight, steps=a.steps,
                    run_dir=a.run_dir)


if __name__ == "__main__":
    main()
