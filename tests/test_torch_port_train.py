"""The port's trainer (sednet_tpu_torch.train) against the JAX package's on
the CPU: one train step from JAX's init parameters on the same batch and
the same random draws (loss, metrics, gradients, the updated parameters),
the schedules, the clip, the init, the checkpoints both ways, the data
order, and `train` end to end on small h5 files."""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sednet_tpu import train as jtrain
from sednet_tpu.config import Config as JaxConfig
from sednet_tpu.data import datasets as jdata
from sednet_tpu.losses import TripletConfig as JaxTripletConfig
from sednet_tpu_torch import train as ttrain
from sednet_tpu_torch.config import Config
from sednet_tpu_torch.data import datasets as tdata
from sednet_tpu_torch.data import make_synthetic_shape
from sednet_tpu_torch.models.init import init_like_flax, truncated_normal
from sednet_tpu_torch.ops import graph
from sednet_tpu_torch.weights import (flat_from_params, params_from_flat,
                                      save_params_npz)

from test_torch_port_losses import jax_triplet_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K, B, EMBED = 256, 16, 2, 32
CFG_KW = dict(num_points=N, knn=K, embed=EMBED, batch_size=B, edge_topk=N,
              ms_max_clusters=12, seed=3)


def flatten(tree, prefix=""):
    """A JAX parameter tree as the flat "a/b/c" numpy arrays of
    `sednet_tpu/train.py save_params_npz`."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _arrays(seed, n_shapes, n_points=N):
    rng = np.random.RandomState(seed)
    raw = [make_synthetic_shape(rng, n_points=n_points, n_segments=5)
           for _ in range(n_shapes)]
    return {k: np.stack([d[k] for d in raw]) for k in
            ("points", "labels", "normals", "prim", "edges", "edges_w")}


def _train_batch(seed=0):
    """One augmented training batch of B shapes from the port's dataset."""
    a = _arrays(seed, B)
    ds = tdata._H5Dataset(a["points"], a["labels"], a["normals"], a["prim"],
                          a["edges"], a["edges_w"], train=True, num_points=N,
                          max_segments=CFG_KW["ms_max_clusters"], seed=seed)
    return next(iter(tdata.BatchLoader(ds, B, shuffle=False)))


def _record_grads():
    """A gradient transformation that keeps the gradients in its state and
    passes them on, so that JAX's own train step gives them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def step_pair():
    """One train step of JAX's `make_train_step` (optimizer: the gradient
    recorder chained before `make_optimizer`'s AdamW) and of the port's,
    from JAX's init parameters, on one batch and JAX's triplet draws."""
    jcfg, cfg = JaxConfig(**CFG_KW), Config(**CFG_KW)
    batch = _train_batch()
    jmodel = jtrain.build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((B, N, 6)))["params"]
    flat0 = flatten(params)
    opt = optax.chain(_record_grads(), jtrain.make_optimizer(jcfg))
    state = jtrain.TrainState(params, opt.init(params), jnp.int32(0))
    key = jax.random.PRNGKey(11)
    draws = jax_triplet_draws(
        key, batch["labels"],
        JaxTripletConfig(margin=jcfg.triplet_margin,
                         max_segments=jcfg.ms_max_clusters))
    step = jtrain.make_train_step(jmodel, opt, jcfg)
    new_state, jmetrics = step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
    jgrads = flatten(new_state.opt_state[0])
    jnew = flatten(new_state.params)

    model = ttrain.build_model(cfg)
    model.load_state_dict(params_from_flat(flat0, ""), strict=True)
    optimizer = ttrain.make_optimizer(cfg, model.parameters())
    tbatch = ttrain.to_device(batch, "cpu")
    tdraws = [torch.from_numpy(d.copy()) for d in draws]
    before = graph.gather_reduce_backward.launches
    tmetrics = ttrain.make_train_step(model, optimizer, cfg)(tbatch, tdraws)
    assert graph.gather_reduce_backward.launches == before  # CPU: plain
    tgrads = flat_from_params({k: p.grad for k, p in
                               model.named_parameters()})
    tnew = flat_from_params(model.state_dict())
    return dict(jmetrics=jmetrics, jgrads=jgrads, jnew=jnew,
                tmetrics=tmetrics, tgrads=tgrads, tnew=tnew, flat0=flat0)


@pytest.mark.parametrize("name", ["loss", "emb", "type", "edge_cls",
                                  "edge_embed", "iou"])
def test_train_step_metrics_match_jax(step_pair, name):
    got = float(step_pair["tmetrics"][name])
    want = float(step_pair["jmetrics"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_step_gradients_match_jax(step_pair):
    jg, tg = step_pair["jgrads"], step_pair["tgrads"]
    assert set(jg) == set(tg) and len(jg) == 45
    errs = {k: float(np.linalg.norm(tg[k] - jg[k])
                     / max(np.linalg.norm(jg[k]), 1e-30)) for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def test_train_step_updated_parameters_match_jax(step_pair):
    """AdamW's first step is about -lr * sign(g): compare where |g_jax| is
    above 1e-6 (below, optax's and torch's rounding orders may move a
    parameter in opposite directions), and check that every parameter
    moved by at most lr (plus the decay) on both sides."""
    jg, jnew, tnew = (step_pair[k] for k in ("jgrads", "jnew", "tnew"))
    lr = CFG_KW.get("lr", Config().lr)
    for key, want in jnew.items():
        mask = np.abs(jg[key]) > 1e-6
        np.testing.assert_allclose(tnew[key][mask], want[mask], atol=1e-6,
                                   err_msg=key)
        step = np.abs(tnew[key] - step_pair["flat0"][key])
        assert float(step.max()) <= 1.01 * lr + 1e-7, key


# --- schedules, clip, init, weights ------------------------------------------

@pytest.mark.parametrize("kind", ["plateau", "cos"])
def test_schedulers_match_jax(kind):
    crit = [5.0, 4.0, 4.5, 4.5, 4.2, 4.1, 4.3, 4.0, 4.6, 4.7, 4.8, 4.9, 5.0,
            3.0, 3.5, 3.6, 3.7, 3.8, 3.9, 4.0, 4.1, 4.2, 4.3]
    if kind == "cos":
        pair = (jtrain.CosineScheduler(1e-3), ttrain.CosineScheduler(1e-3))
    else:
        pair = (jtrain.PlateauScheduler(1e-3, patience=2),
                ttrain.PlateauScheduler(1e-3, patience=2))
    want = [pair[0].step(c) for c in crit]
    got = [pair[1].step(c) for c in crit]
    assert got == want and len(set(got)) > 2


# optax scales by max_norm / g_norm unless g_norm < max_norm: below, at and
# above the global norm (sqrt(sum of squares) = 5 for these gradients)
@pytest.mark.parametrize("max_norm", [0.5, 5.0, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    grads = {"a": np.array([3.0, 0.0], np.float32),
             "b": np.array([[0.0, 4.0]], np.float32)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in grads.values()]
    for p, v in zip(params, grads.values()):
        p.grad = torch.from_numpy(v.copy())
    norm = ttrain.clip_by_global_norm(params, max_norm)
    assert float(norm) == pytest.approx(5.0)
    for p, k in zip(params, grads):
        np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want[k]))


def test_init_like_flax_draws_flax_defaults(step_pair):
    cfg = Config(**CFG_KW)
    model = init_like_flax(ttrain.build_model(cfg),
                           torch.Generator().manual_seed(4))
    again = init_like_flax(ttrain.build_model(cfg),
                           torch.Generator().manual_seed(4))
    jparams = step_pair["flat0"]   # flax's init of the same model
    for key, w in model.state_dict().items():   # the same seed, the same draws
        assert torch.equal(again.state_dict()[key], w), key
    flat = flat_from_params(model.state_dict())
    assert set(flat) == set(jparams)
    for key, w in flat.items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "bias":
            assert not w.any() and not jparams[key].any()
        elif leaf == "scale":
            assert (w == 1).all() and (jparams[key] == 1).all()
        else:
            std = np.sqrt(1.0 / w.shape[0])
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
            if w.size >= 10000:   # both within 3% of lecun_normal's std
                for arr in (w, jparams[key]):
                    assert abs(arr.std() / std - 1) < 0.03, key


def test_truncated_normal_statistics():
    x = truncated_normal((200000,), torch.Generator().manual_seed(0))
    assert float(x.abs().max()) <= 2.0
    assert abs(float(x.mean())) < 0.01
    assert abs(float(x.std()) - 0.87962566103423978) < 0.005


def test_flat_from_params_inverts_params_from_flat(tmp_path):
    with np.load(os.path.join(ROOT, "checkpoints", "bench_10k.npz")) as f:
        flat = {k[len("inst/"):]: f[k] for k in f.files
                if k.startswith("inst/")}
    back = flat_from_params(params_from_flat(flat, ""))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    model = ttrain.build_model(Config())
    model.load_state_dict(params_from_flat(flat, ""))
    path = str(tmp_path / "m.npz")
    save_params_npz(path, model)
    tree = jtrain.load_params(path)
    assert flatten(tree).keys() == flat.keys()
    for k, v in flatten(tree).items():
        np.testing.assert_array_equal(v, flat[k])


# Both flags, once refused, now build: bf16 compute with float32
# parameters, and the direct edge convolution in every layer.
@pytest.mark.parametrize("field,value", [("model_bf16", True),
                                         ("factored_gn", False)])
def test_build_model_refuses_what_is_not_ported(field, value):
    model = ttrain.build_model(Config(**{field: value}))
    convs = [model.encoder.conv1, model.encoder.conv2, model.encoder.conv3]
    if field == "model_bf16":
        assert model.dtype == torch.bfloat16
        assert all(c.dtype == torch.bfloat16 for c in convs)
    else:
        assert model.dtype == torch.float32
        assert not any(c.factored_gn for c in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())


# An orbax directory and a reference .pth, once refused, now give the
# leaves of JAX's load_params; a path that does not exist raises.
@pytest.mark.parametrize("path", ["trains/x/ckpts/best_inst",
                                  "weights/sednet.pth"])
def test_load_params_names_what_is_not_ported(path, tmp_path):
    import orbax.checkpoint as ocp
    from sednet_tpu.utils.torch_import import flax_params_to_torch_state_dict

    target = str(tmp_path / path)
    with pytest.raises(FileNotFoundError):
        ttrain.load_params(target)
    params = jtrain.load_params(os.path.join(ROOT, "checkpoints",
                                             "bench_10k.npz"))["type"]
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if target.endswith(".pth"):
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                    flax_params_to_torch_state_dict(params).items()}, target)
    else:
        ocp.PyTreeCheckpointer().save(target, params)
    want = params_from_flat(flatten(jtrain.load_params(target)), "")
    got = ttrain.load_params(target)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# mesh_shape > 1, once refused, trains data-parallel
# (tests/test_torch_port_parallel.py); a batch the mesh does not divide
# raises JAX's error before anything starts.
def test_train_needs_the_card_or_cpu_and_one_device(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        ttrain.train(Config(mesh_shape=2, batch_size=3),
                     run_dir=str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main([os.path.join(ROOT, "configs", "config_SEDNet_normal.yml"),
                     "--steps", "1", "--run-dir", str(tmp_path)])


# --- data ---------------------------------------------------------------------

def _mixed(pkg, arrays, n, seed):
    first = pkg._H5Dataset(*(arrays[0][k] for k in (
        "points", "labels", "normals", "prim")), train=True, num_points=n,
        max_segments=12)
    second = pkg._H5Dataset(*(arrays[1][k] for k in (
        "points", "labels", "normals", "prim", "edges", "edges_w")),
        train=True, num_points=n, max_segments=12)
    return pkg.BatchLoader(pkg.MixedDataset(first, second), 2, shuffle=True,
                           seed=seed)


# The same RandomState calls on both sides: the same shuffles, augmentation
# draws and subsamples (a cloud of 160 points cut to 128), so the same
# batches over two epochs, bit for bit; the port's through its prefetch.
def test_mixed_training_batches_match_jax():
    arrays = [_arrays(1, 3, 160), _arrays(2, 3, 160)]
    jl = _mixed(jdata, arrays, 128, seed=5)
    tl = tdata.PrefetchLoader(_mixed(tdata, arrays, 128, seed=5))
    assert len(tl) == len(jl) == 3
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class _Batches:
    """A loader of `n` small batches, slow to make, that may fail."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise KeyError("bad item")
            time.sleep(0.01)
            yield {"i": np.array([i])}


def test_prefetch_loader_order_errors_and_early_abandon():
    assert [int(b["i"][0]) for b in tdata.PrefetchLoader(_Batches(7))] == \
        list(range(7))
    with pytest.raises(KeyError, match="bad item"):
        list(tdata.PrefetchLoader(_Batches(7, fail_at=3), depth=1))
    before = set(threading.enumerate())
    it = iter(tdata.PrefetchLoader(_Batches(1000), depth=2))
    assert int(next(it)["i"][0]) == 0
    it.close()   # the consumer leaves with the queue full
    deadline = time.time() + 5
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


# --- train end to end ---------------------------------------------------------

TRAIN_KW = dict(num_points=128, knn=8, embed=16, batch_size=2, eval_T=2,
                warmup_steps=2, ms_max_clusters=12, edge_topk=128, seed=1,
                hpnet_embed=False, num_test=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train(..., device="cpu")` for 3 steps on small ParseNet and edge h5
    files written by the port's writers (4 shapes each a split), evals at
    steps 2 and 3, the learning rates it sets recorded."""
    from sednet_tpu_torch.data import write_edge_h5, write_parsenet_h5

    root = str(tmp_path_factory.mktemp("train"))
    write_parsenet_h5(root, n_shapes=4, n_points=128, seed=0)
    write_edge_h5(root, n_shapes=4, n_points=128, seed=1)
    run_dir = os.path.join(root, "run")
    lrs = []
    set_lr = ttrain.set_learning_rate

    def record(optimizer, lr):
        lrs.append(lr)
        return set_lr(optimizer, lr)

    ttrain.set_learning_rate = record
    try:
        state, history = ttrain.train(Config(**TRAIN_KW), data_root=root,
                                      max_steps=3, run_dir=run_dir,
                                      log_every=1, device="cpu")
    finally:
        ttrain.set_learning_rate = set_lr
    return dict(root=root, run_dir=run_dir, state=state, history=history,
                lrs=lrs)


def test_train_runs_warmup_evals_and_writes_records(trained):
    history, run_dir = trained["history"], trained["run_dir"]
    assert [r["step"] for r in history] == [2, 3] and trained["state"].step == 3
    for r in history:
        for k, v in r.items():
            if k != "saved":
                assert np.isfinite(v), k
    assert history[0]["saved"] == ["best_total", "best_inst", "best_type"]
    lr = TRAIN_KW.get("lr", Config().lr)
    # warmup lr * 1/2, lr * 2/2; then the plateau schedule at each eval
    assert trained["lrs"] == [lr / 2, lr, lr, lr]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert [json.loads(line) for line in f] == history
    for name in ("best_total.npz", "best_inst.npz", "best_type.npz",
                 "latest.npz", "latest_opt.pt"):
        assert os.path.exists(os.path.join(run_dir, "ckpts", name))
    assert os.path.exists(os.path.join(run_dir, "config.json"))


# JAX's load_params reads the port's checkpoint; JAX's forward on it equals
# the port's on the trained model (float association: atol 1e-4).
def test_train_checkpoints_give_jax_the_same_forward(trained):
    from sednet_tpu_torch.weights import load_checkpoint

    path = os.path.join(trained["run_dir"], "ckpts", "latest.npz")
    x = _arrays(9, 2, 128)
    x = np.concatenate([x["points"], x["normals"]], -1).astype(np.float32)
    jmodel = jtrain.build_model(JaxConfig(**TRAIN_KW))
    want = jax.jit(jmodel.apply)({"params": jtrain.load_params(path)},
                                 jnp.asarray(x))
    model = load_checkpoint(path, Config(**TRAIN_KW), device="cpu")
    for key, p in trained["state"].model.state_dict().items():
        assert torch.equal(model.state_dict()[key], p)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for name in ("embedding", "type_log_prob", "edge_logits"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-4,
                                   err_msg=name)


def test_run_prediction_reads_the_trained_checkpoints(trained, tmp_path):
    from sednet_tpu_torch.predict import run_prediction

    ck = os.path.join(trained["run_dir"], "ckpts")
    cfg = Config(**TRAIN_KW,
                 pretrain_model_path=os.path.join(ck, "best_type.npz"),
                 pretrain_model_type_path=os.path.join(ck, "best_inst.npz"))
    summary, results = run_prediction(cfg, data_root=trained["root"],
                                      batch_size=2, save_viz=False,
                                      out_dir=str(tmp_path), device="cpu")
    assert summary["n_shapes"] == len(results) == 4
    for r in results:
        assert 0.0 <= r["inst_iou"] <= 1.0 and 0.0 <= r["type_iou"] <= 1.0


# A second run preloads the checkpoint tolerantly (a wider embedding: the
# last layer keeps its init, every other leaf is the checkpoint's) and
# resumes the optimizer (its step count goes on, its lr is cfg.lr's).
def test_train_preloads_tolerantly_and_resumes_the_optimizer(trained,
                                                             tmp_path):
    ck = os.path.join(trained["run_dir"], "ckpts")
    cfg = Config(**{**TRAIN_KW, "embed": 24, "warmup_steps": 0, "lr": 3e-4},
                 preload_model=True,
                 pretrain_model_path=os.path.join(ck, "latest.npz"))
    template = init_like_flax(ttrain.build_model(cfg),
                              torch.Generator().manual_seed(cfg.seed))
    merged = ttrain.load_params_tolerant(template.state_dict(),
                                         cfg.pretrain_model_path)
    saved = ttrain.load_params(cfg.pretrain_model_path)
    for key, value in merged.items():
        src = template.state_dict() if key.startswith("mlp_seg_prob2") \
            else saved
        assert torch.equal(value, src[key]), key

    cfg_opt = Config(**{**TRAIN_KW, "warmup_steps": 0, "lr": 3e-4},
                     preload_model=True,
                     pretrain_model_path=os.path.join(ck, "latest.npz"),
                     pretrain_opti_path=os.path.join(ck, "latest_opt.pt"))
    state, history = ttrain.train(cfg_opt, data_root=trained["root"],
                                  max_steps=1, run_dir=str(tmp_path),
                                  device="cpu")
    st = state.optimizer.state_dict()
    assert {int(s["step"]) for s in st["state"].values()} == {4}
    assert history[0]["lr"] == 3e-4


# The normal head (`predict_normal`) feeds no loss term: jax.grad gives its
# parameters a gradient of 0, and optax's AdamW still decays them. The
# port's step fills those gradients with zeros (torch's AdamW skips a
# parameter whose .grad is None), so one step moves each of them as
# optax's AdamW moves it on a zero gradient (atol 1e-7).
def test_train_step_decays_the_normal_head_as_optax():
    cfg = Config(**CFG_KW, predict_normal=True)
    jcfg = JaxConfig(**CFG_KW, predict_normal=True)
    model = ttrain.init_like_flax(ttrain.build_model(cfg),
                                  torch.Generator().manual_seed(0))
    head = {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith("normal_")}
    optimizer = ttrain.make_optimizer(cfg, model.parameters())
    ttrain.make_train_step(model, optimizer, cfg)(
        ttrain.to_device(_train_batch(), "cpu"),
        generator=torch.Generator().manual_seed(1))
    params = {k: jnp.asarray(v.numpy()) for k, v in head.items()}
    opt = jtrain.make_optimizer(jcfg)
    updates, _ = opt.update(jax.tree.map(jnp.zeros_like, params),
                            opt.init(params), params)
    want = optax.apply_updates(params, updates)
    for k, v in want.items():
        got = model.state_dict()[k].numpy()
        assert not np.array_equal(got, head[k].numpy()) or not head[k].any()
        np.testing.assert_allclose(got, np.asarray(v), atol=1e-7, err_msg=k)
