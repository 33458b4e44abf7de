"""The multi-rank dry run: the twin of `__graft_entry__.py:29
dryrun_multichip`, on cards (a card a rank) or on gloo ranks of the CPU.

    python -m sednet_tpu_torch.parallel.dryrun [N] [--cpu]

One data-parallel train step of a tiny model (64 points, k 8, embedding
16, a shape a rank) over N ranks, the step equal to the one-process step
on the whole batch; then the sharded inference (forward and a mean-shift
a shape, the shapes split over the ranks) on synthetic multi-segment CAD
shapes, its labels equal to one process's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.parallel.mesh import (Mesh, gather_objects, local_rows,
                                            spawn)

N_POINTS = 64


def _config(n: int):
    from sednet_tpu_torch.config import Config

    return Config(num_points=N_POINTS, knn=8, embed=16, batch_size=n,
                  edge_topk=16, mesh_shape=n)


def _batch(n: int) -> dict:
    rng = np.random.RandomState(0)
    return {
        "points": rng.randn(n, N_POINTS, 3).astype(np.float32),
        "normals": rng.randn(n, N_POINTS, 3).astype(np.float32),
        "labels": rng.randint(0, 4, (n, N_POINTS)).astype(np.int64),
        "prim": rng.randint(0, 6, (n, N_POINTS)).astype(np.int64),
        "edges": rng.randint(0, 2, (n, N_POINTS)).astype(np.int64),
        "edges_w": np.ones((n, N_POINTS), np.float32)}


def _clouds(n: int) -> torch.Tensor:
    from sednet_tpu_torch.data import (make_synthetic_shape, normalize_points,
                                       pca_align)

    rng = np.random.RandomState(1)
    clouds = []
    for _ in range(n):
        d = make_synthetic_shape(rng, n_points=N_POINTS, n_segments=4)
        p, nr, _ = pca_align(normalize_points(d["points"]), d["normals"])
        clouds.append(np.concatenate([p, nr], -1).astype(np.float32))
    return torch.from_numpy(np.stack(clouds))


def _step(model, cfg, mesh: Mesh | None, device):
    """One train step (data-parallel where mesh is given). Returns (loss,
    the gradients it applied)."""
    from sednet_tpu_torch.train import (make_optimizer, make_train_step,
                                        to_device)

    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, cfg, mesh)
    metrics = step(to_device(_batch(cfg.batch_size), device),
                   generator=torch.Generator().manual_seed(1))
    return float(metrics["loss"]), {
        k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()}


def _infer(model, n: int, mesh: Mesh | None, device):
    """Forward and a mean-shift a shape on the synthetic clouds, the
    shapes split over the ranks where mesh is given. Returns (labels (B,
    N), cluster counts, type predictions), gathered."""
    from sednet_tpu_torch.cluster.mean_shift import mean_shift

    x = _clouds(n).to(device)
    rows = range(n) if mesh is None else range(
        *local_rows(n, mesh).indices(n))
    out = []
    with torch.no_grad():
        for i in rows:
            o = model(x[i:i + 1])
            emb = o.embedding[0] / torch.clamp_min(torch.linalg.vector_norm(
                o.embedding[0], dim=-1, keepdim=True), 1e-12)
            r = mean_shift(emb, num_samples=N_POINTS, iterations=30,
                           generator=torch.Generator().manual_seed(2 + i))
            out.append((r.labels.cpu().numpy(), int(r.num_clusters),
                        o.type_log_prob[0].argmax(-1).cpu().numpy()))
    if mesh is not None:
        out = [o for part in gather_objects(out, mesh) for o in part]
    return tuple(np.stack([o[j] for o in out]) for j in range(3))


def _model(cfg, device):
    from sednet_tpu_torch.models.init import init_like_flax
    from sednet_tpu_torch.train import build_model

    return init_like_flax(build_model(cfg),
                          torch.Generator().manual_seed(0)).to(device)


def dryrun_rank(mesh: Mesh):
    """A rank's part: the data-parallel step, then the sharded inference on
    the stepped model. Returns (loss, gradients, stepped parameters,
    labels, counts, types, the rank's torch thread count)."""
    cfg = _config(mesh.size)
    model = _model(cfg, mesh.device)
    loss, grads = _step(model, cfg, mesh, mesh.device)
    params = {k: v.detach().cpu().numpy()
              for k, v in model.state_dict().items()}
    return (loss, grads, params) + _infer(model, mesh.size, mesh,
                                          mesh.device) + (
        torch.get_num_threads(),)


def check_dryrun(ranks, n_devices: int, device=None) -> dict:
    """Hold the ranks' result (`dryrun_rank`'s, rank 0's) to one process:
    the step's loss (rtol 1e-5) and gradients (1e-5 relative L2 a leaf:
    float32 summation order over the batch), and, on the ranks' stepped
    parameters, the sharded inference's labels, counts and types exactly
    (a shape computes wholly on one rank). The one process runs on
    `device` (None: the card; "cpu"). Returns {"loss", "grad_rel_err",
    "num_clusters"}."""
    loss, grads, params, labels, nums, types, threads = ranks
    dev = resolve_device(device)
    cfg = _config(n_devices)
    model = _model(cfg, dev)
    loss1, grads1 = _step(model, cfg, None, dev)
    assert np.isfinite(loss) and abs(loss - loss1) <= 1e-5 * max(
        1.0, abs(loss1)), (loss, loss1)
    err = max(float(np.linalg.norm(grads[k] - grads1[k])
                    / max(np.linalg.norm(grads1[k]), 1e-30)) for k in grads)
    assert err <= 1e-5, err
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    # the CPU's float sums depend on how many threads split them: the
    # ranks' count, so that a shape computes as on its rank
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        labels1, nums1, types1 = _infer(model, n_devices, None, dev)
    finally:
        torch.set_num_threads(before)
    assert labels.shape == (n_devices, N_POINTS)
    assert (nums >= 1).all() and (nums <= N_POINTS).all(), nums
    np.testing.assert_array_equal(labels, labels1)
    np.testing.assert_array_equal(nums, nums1)
    np.testing.assert_array_equal(types, types1)
    return {"loss": loss, "grad_rel_err": err,
            "num_clusters": nums.tolist()}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run over n_devices new ranks (None: a card a rank, and
    without CUDA it raises; "cpu": gloo ranks on the CPU), held to one
    process (`check_dryrun`)."""
    rec = check_dryrun(spawn("sednet_tpu_torch.parallel.dryrun:dryrun_rank",
                             n_devices, device=device, timeout=300.0),
                       n_devices, device)
    print(f"dryrun_multichip({n_devices}): ok, loss={rec['loss']:.4f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="the multi-rank dry run")
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU instead of a card a rank")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n, "cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
