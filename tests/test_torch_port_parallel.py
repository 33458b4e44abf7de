"""Multi-device execution of the port (`sednet_tpu_torch/parallel/`, the
data-parallel train step and predict) on gloo ranks of the CPU, against the
one-process port and the JAX package's `make_mesh(M)` on the conftest's
8-device CPU mesh, at M = 2 and 4.

Every rank computation of one M runs in one spawn of M processes
(`parallel.mesh.spawn`, 120 s, the children killed on expiry), whose rank 0
returns every case's gathered result; the tests compare them. JAX is
imported inside the tests only, so that the ranks, which import this
module, load no JAX."""
import numpy as np
import pytest
import torch

N, K, B = 256, 16, 4
SPAWN_TIMEOUT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread here and in every rank (`spawn` shares out this
    process's): the tensors are small, and in a parallel test run more
    threads only compete with the other workers'. The ranks and this
    process then also sum in the same order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed=0, n=N):
    from sednet_tpu_torch.data import make_synthetic_shape

    d = make_synthetic_shape(np.random.RandomState(seed), n_points=n,
                             n_segments=5)
    return np.concatenate([d["points"], d["normals"]], -1).astype(np.float32)


def _unit_rows(seed=1, n=N, e=16):
    rng = np.random.RandomState(seed)
    c = rng.randn(5, e)
    x = c[rng.randint(0, 5, n)] + 0.1 * rng.randn(n, e)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _train_cfg(m, cfg_kw):
    from sednet_tpu_torch.config import Config

    return Config(**{**cfg_kw, "batch_size": B, "mesh_shape": m})


PREDICT_KW = dict(num_points=N, knn=K, embed=128, hpnet_embed=True,
                  ms_num_samples=5000, ms_tol=0.0)


def rank_cases(mesh, inputs):
    """Every case on one rank; rank 0's return value holds the gathered
    results."""
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.parallel import (big_cloud_segment,
                                           big_sednet_forward,
                                           mean_shift_iterate_sharded,
                                           ring_knn)
    from sednet_tpu_torch.parallel.dryrun import dryrun_rank
    from sednet_tpu_torch.parallel.mesh import (all_gather_rows, local_rows,
                                                replicate, shard_batch)
    from sednet_tpu_torch.predict import load_models, predict_shapes_mesh
    from sednet_tpu_torch.train import (build_model, make_optimizer,
                                        make_train_step, to_device)

    out = {}
    # JAX's mesh names: a rank's slice of the batch axis, rank 0's
    # parameters broadcast
    out["shard"] = all_gather_rows(shard_batch(
        {"a": torch.arange(2 * B)}, mesh)["a"], mesh)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(mesh.rank))
    out["replicated"] = all_gather_rows(replicate(lin, mesh).weight.detach()
                                        .clone(), mesh)
    x = torch.from_numpy(inputs["cloud"])
    sl = local_rows(N, mesh)
    for name, rows, metric in (("ring_pn", x, "points_normals"),
                               ("ring_sq", torch.from_numpy(inputs["feat"]),
                                "sqdist")):
        idx, dist = ring_knn(rows[sl].contiguous(), K, mesh, metric=metric)
        out[name] = (all_gather_rows(idx, mesh), all_gather_rows(dist, mesh))
    u = torch.from_numpy(inputs["unit"])
    out["ms"] = all_gather_rows(mean_shift_iterate_sharded(
        u[sl].contiguous(), inputs["bw"], mesh, iterations=10), mesh)

    pcfg = Config(**PREDICT_KW)
    models = load_models(inputs["ckpt"], pcfg, device="cpu")
    model = models["inst"]
    big = big_sednet_forward(model, x, mesh)
    out["big"] = [all_gather_rows(t, mesh) for t in big]
    out["segment"] = big_cloud_segment(
        model, x, mesh, torch.Generator().manual_seed(0),
        bandwidth_samples=N, iterations=20)[:2]

    cfg = _train_cfg(mesh.size, inputs["cfg_kw"])
    tmodel = build_model(cfg)
    tmodel.load_state_dict({k: torch.from_numpy(v)
                            for k, v in inputs["state"].items()})
    opt = make_optimizer(cfg, tmodel.parameters())
    metrics = make_train_step(tmodel, opt, cfg, mesh)(
        to_device(inputs["batch"], "cpu"),
        [torch.from_numpy(d) for d in inputs["draws"]])
    out["train"] = ({k: float(v) for k, v in metrics.items()},
                    {k: p.grad for k, p in tmodel.named_parameters()})

    res = predict_shapes_mesh(models["type"], models["inst"],
                              inputs["predict_batch"], pcfg, mesh,
                              generator=torch.Generator().manual_seed(5))
    out["predict"] = res
    out["dryrun"] = dryrun_rank(mesh)
    return out


def _inputs():
    import jax
    import jax.numpy as jnp
    from sednet_tpu import train as jtrain
    from sednet_tpu.config import Config as JaxConfig
    from sednet_tpu.losses import TripletConfig as JaxTripletConfig
    from sednet_tpu.train import load_params

    from test_torch_port_losses import jax_triplet_draws
    from test_torch_port_train import CFG_KW, _arrays, flatten
    from test_torch_port_predict import CKPT

    jcfg = JaxConfig(**{**CFG_KW, "batch_size": B})
    params = jax.jit(jtrain.build_model(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((B, N, 6)))["params"]
    from sednet_tpu_torch.weights import params_from_flat

    state = {k: v.numpy() for k, v in
             params_from_flat(flatten(params), "").items()}
    batch = _arrays(2, B)
    key = jax.random.PRNGKey(11)
    draws = [np.array(d) for d in jax_triplet_draws(
        key, batch["labels"], JaxTripletConfig(
            margin=jcfg.triplet_margin, max_segments=jcfg.ms_max_clusters))]
    pbatch = {k: v for k, v in _arrays(3, B).items()
              if k in ("points", "normals", "labels", "prim")}
    feat = np.random.RandomState(4).randn(N, 32).astype(np.float32)
    return dict(cloud=_cloud(), feat=feat, unit=_unit_rows(), bw=0.3,
                state=state, jparams=params, jcfg=jcfg, batch=batch,
                draws=draws, key=key, ckpt=CKPT, predict_batch=pbatch,
                cfg_kw=dict(CFG_KW), jinst=load_params(CKPT)["inst"])


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


_RUNS = {}


def _ranks(inputs, m):
    """rank 0's results of `rank_cases` on m gloo ranks (one spawn an m
    for the module)."""
    from sednet_tpu_torch.parallel.mesh import spawn

    if m not in _RUNS:
        sent = {k: v for k, v in inputs.items()
                if k not in ("jparams", "jcfg", "key", "jinst")}
        _RUNS[m] = spawn("test_torch_port_parallel:rank_cases", m, sent,
                         device="cpu", timeout=SPAWN_TIMEOUT)
    return _RUNS[m]


def _jax_mesh(m):
    from sednet_tpu.parallel import make_mesh

    return make_mesh(m)


MS = [2, 4]


# `shard_batch` gives each rank its B/M shapes in rank order, and
# `replicate` every rank rank 0's parameters.
@pytest.mark.parametrize("m", MS)
def test_shard_batch_and_replicate(inputs, m):
    got = _ranks(inputs, m)
    assert torch.equal(torch.from_numpy(got["shard"]), torch.arange(2 * B))
    assert not got["replicated"].any()


# ring_knn against K1's plain version on the whole cloud (by
# `compare_with_plain`: no row outside a near-tie differs) and against
# JAX's ring_knn on make_mesh(M) (the same rule), both metrics.
@pytest.mark.parametrize("m", MS)
def test_ring_knn_matches_k1_and_jax(inputs, m):
    import jax.numpy as jnp
    from sednet_tpu.parallel import ring_knn as jring

    from sednet_tpu_torch.ops.flash_topk import compare_with_plain

    got = _ranks(inputs, m)
    for name, rows, metric in (("ring_pn", inputs["cloud"], "points_normals"),
                               ("ring_sq", inputs["feat"], "sqdist")):
        idx, dist = (torch.from_numpy(t) for t in got[name])
        q = torch.from_numpy(rows)
        rep = compare_with_plain(q, q, K, idx, dist, metric=metric)
        assert rep["bad_rows"] == 0 and rep["max_abs_err"] <= rep["tol"], rep
        jidx, jdist = jring(jnp.asarray(rows), K, _jax_mesh(m), metric=metric)
        rep = compare_with_plain(q, q, K, torch.from_numpy(
            np.asarray(jidx)).long(), torch.from_numpy(np.asarray(jdist)),
            metric=metric)
        assert rep["bad_rows"] == 0, rep
        same = (np.sort(idx.numpy(), 1) == np.sort(np.asarray(jidx), 1)
                ).all(1)
        assert same.mean() >= 0.99, same.mean()


# The sharded shift against the one-process loop (`mean_shift_iterate`,
# atol 1e-6) and JAX's `mean_shift_iterate_sharded` (atol 1e-5), 10 steps.
@pytest.mark.parametrize("m", MS)
def test_mean_shift_iterate_sharded_matches(inputs, m):
    import jax.numpy as jnp
    from sednet_tpu.parallel import mean_shift_iterate_sharded as jms

    from sednet_tpu_torch.cluster.mean_shift import mean_shift_iterate

    got = _ranks(inputs, m)["ms"]
    one = mean_shift_iterate(torch.from_numpy(inputs["unit"]), inputs["bw"],
                             10).numpy()
    np.testing.assert_allclose(got, one, atol=1e-6)
    want = np.asarray(jms(jnp.asarray(inputs["unit"]), inputs["bw"],
                          _jax_mesh(m), iterations=10))
    np.testing.assert_allclose(got, want, atol=1e-5)


# The point-sharded forward against JAX's `big_sednet_forward` on
# make_mesh(M), the trained inst model at k = 16: atol 1e-4.
@pytest.mark.parametrize("m", MS)
def test_big_sednet_forward_matches_jax(inputs, m):
    import jax.numpy as jnp
    from sednet_tpu.parallel import big_sednet_forward as jbig

    got = _ranks(inputs, m)["big"]
    want = jbig(inputs["jinst"], jnp.asarray(inputs["cloud"]),
                _jax_mesh(m), k=K)
    for g, w, name in zip(got, want, ("embedding", "type_log_prob",
                                      "edge_logits")):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, err_msg=name)


# The big cloud's labels against JAX's `big_cloud_segment` (every row in
# the bandwidth's subsample, so that the two draw the same bandwidth):
# the same partition and count.
@pytest.mark.parametrize("m", MS)
def test_big_cloud_segment_matches_jax(inputs, m):
    import jax
    import jax.numpy as jnp
    from sednet_tpu.parallel import big_cloud_segment as jseg

    from test_torch_port_predict import ari

    labels, num = _ranks(inputs, m)["segment"]
    jl, jn, _, _ = jseg(inputs["jinst"], jnp.asarray(inputs["cloud"]),
                        _jax_mesh(m), jax.random.PRNGKey(0), k=K,
                        bandwidth_samples=N, iterations=20)
    assert int(num) == int(jn)
    assert ari(labels, np.asarray(jl)) == 1.0


# The data-parallel train step against the one-process step on the whole
# batch (the same draws): metrics at rtol 1e-5, gradients at 1e-5 relative
# L2 a leaf (float32 summation order over the batch); and against JAX's
# step on make_mesh(M) at JAX's train-step bars (tests of
# test_torch_port_train.py: rtol 1e-5, 1e-4).
@pytest.mark.parametrize("m", MS)
def test_data_parallel_train_step_matches(inputs, m):
    import jax
    import jax.numpy as jnp
    import optax
    from sednet_tpu import train as jtrain
    from sednet_tpu.parallel import replicate as jrep
    from sednet_tpu.parallel import shard_batch as jshard

    from sednet_tpu_torch import train as ttrain
    from sednet_tpu_torch.weights import flat_from_params

    from test_torch_port_train import _record_grads, flatten

    metrics, grads = _ranks(inputs, m)["train"]
    cfg = _train_cfg(m, inputs["cfg_kw"])
    model = ttrain.build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inputs["state"].items()})
    one = ttrain.make_train_step(
        model, ttrain.make_optimizer(cfg, model.parameters()), cfg)(
        ttrain.to_device(inputs["batch"], "cpu"),
        [torch.from_numpy(d) for d in inputs["draws"]])
    for k, v in one.items():
        assert metrics[k] == pytest.approx(float(v), rel=1e-5), k
    for k, p in model.named_parameters():
        g = p.grad.numpy()
        assert (np.linalg.norm(grads[k] - g)
                <= 1e-5 * max(np.linalg.norm(g), 1e-30)), k

    jcfg, mesh = inputs["jcfg"], _jax_mesh(m)
    opt = optax.chain(_record_grads(), jtrain.make_optimizer(jcfg))
    # a copy: the step donates its state's buffers
    params = jax.tree.map(jnp.array, inputs["jparams"])
    state = jtrain.TrainState(jrep(params, mesh), jrep(opt.init(params),
                                                       mesh), jnp.int32(0))
    new, jm = jtrain.make_train_step(jtrain.build_model(jcfg), opt, jcfg)(
        state, jshard({k: jnp.asarray(v) for k, v in inputs["batch"].items()},
                      mesh), inputs["key"])
    assert metrics["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    jg = flatten(jax.device_get(new.opt_state[0]))
    tg = flat_from_params({k: torch.from_numpy(v) for k, v in grads.items()})
    for k in jg:
        assert (np.linalg.norm(tg[k] - jg[k])
                <= 1e-4 * max(np.linalg.norm(jg[k]), 1e-30)), k


# Data-parallel predict: every rank draws the whole batch's random inputs
# (`batch_draws`, which are the draws of one `predict_shapes` call on the
# whole batch: the same results from the same seed), runs its shapes on
# them, and the gathered results are, bit for bit, one process's
# `predict_shapes` on each rank's shapes with those draws (a batch of B/M
# shapes and one of B differ only in the float association of the batched
# forward, which at this size can split a cluster: see
# test_torch_port_cli.py).
@pytest.mark.parametrize("m", MS)
def test_data_parallel_predict_matches_one_process(inputs, m):
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.predict import (batch_draws, load_models,
                                          predict_shapes)

    got = _ranks(inputs, m)["predict"]
    cfg = Config(**PREDICT_KW)
    models = load_models(inputs["ckpt"], cfg, device="cpu")
    batch = inputs["predict_batch"]
    x0s, sels = batch_draws(batch, cfg, torch.Generator().manual_seed(5))
    want = []
    for r in range(m):
        sl = slice(r * B // m, (r + 1) * B // m)
        want += predict_shapes(
            models["type"], models["inst"],
            {k: v[sl] for k, v in batch.items()}, cfg,
            generator=torch.Generator().manual_seed(5), x0s=x0s[sl],
            sels=sels[sl])
    whole = predict_shapes(models["type"], models["inst"], batch, cfg,
                           generator=torch.Generator().manual_seed(5))
    again = predict_shapes(models["type"], models["inst"], batch, cfg,
                           x0s=x0s, sels=sels)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    for a, b in zip(whole, again):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# The dry run's twin (`parallel.dryrun`): the ranks' step held to one
# process's, and the sharded inference's labels, counts and types to one
# process's on the ranks' stepped parameters.
@pytest.mark.parametrize("m", MS)
def test_dryrun_multichip_twin(inputs, m):
    from sednet_tpu_torch.parallel.dryrun import check_dryrun

    rec = check_dryrun(_ranks(inputs, m)["dryrun"], m, "cpu")
    assert np.isfinite(rec["loss"]) and rec["grad_rel_err"] <= 1e-5


# The entry points start their own ranks: `run_prediction(mesh_devices=M)`
# on written h5 files equals the one-process run, and a batch the mesh
# does not divide raises JAX's error.
def test_run_prediction_mesh_devices(tmp_path):
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.data import write_parsenet_h5
    from sednet_tpu_torch.predict import load_models, run_prediction

    from test_torch_port_predict import CKPT

    root = str(tmp_path)
    write_parsenet_h5(root, n_shapes=4, n_points=128, seed=0)
    cfg = Config(num_points=128, knn=K, hpnet_embed=False, num_test=0)
    models = load_models(CKPT, cfg, device="cpu")
    kw = dict(data_root=root, save_viz=False, batch_size=2, device="cpu",
              params_type=models["type"], params_inst=models["inst"])
    one, _ = run_prediction(cfg, **kw)
    two, _ = run_prediction(cfg, mesh_devices=2, **kw)
    assert two == one
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        run_prediction(cfg, mesh_devices=2, **{**kw, "batch_size": 3})


# `train` with mesh_shape = 2 starts its own two gloo ranks and trains on
# small h5 files: the same history as one process (losses within float32
# summation order over the batch, rtol 1e-4), rank 0's checkpoints, and
# the same parameters: AdamW's first step moves each by about lr times the
# sign of its gradient, so where a gradient is near 0 the two sums may
# take opposite signs; every parameter within 2 lr of one process's, and
# at most one in 1000 further than 1e-6 from it (one step, an eval).
def test_train_mesh_shape_two(tmp_path):
    import os

    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.data import write_edge_h5, write_parsenet_h5
    from sednet_tpu_torch.train import train

    from test_torch_port_train import TRAIN_KW

    root = str(tmp_path)
    write_parsenet_h5(root, n_shapes=4, n_points=128, seed=0)
    write_edge_h5(root, n_shapes=4, n_points=128, seed=1)
    kw = dict(data_root=root, max_steps=1, log_every=1, device="cpu")
    one, h1 = train(Config(**TRAIN_KW), run_dir=os.path.join(root, "one"),
                    **kw)
    two, h2 = train(Config(**{**TRAIN_KW, "mesh_shape": 2}),
                    run_dir=os.path.join(root, "two"), **kw)
    assert two.step == one.step == 1 and len(h2) == len(h1) == 1
    for a, b in zip(h2, h1):
        for key in ("TrL", "TsL", "criterion"):
            assert a[key] == pytest.approx(b[key], rel=1e-4), key
    sd1, sd2 = one.model.state_dict(), two.model.state_dict()
    diff = torch.cat([(sd2[k] - sd1[k]).abs().reshape(-1) for k in sd1])
    assert float(diff.max()) <= 2 * Config().lr
    assert float((diff > 1e-6).float().mean()) <= 1e-3
    assert os.path.exists(os.path.join(root, "two", "ckpts", "latest.npz"))


# A one-rank mesh (gloo, in this process) takes the sharded code, not a
# shortcut: the dry run's data-parallel step issues its all-gather and
# all-reduce (`parallel.mesh.COLLECTIVES`), and its loss and gradients
# equal the one-process step's bit for bit.
def test_one_rank_mesh_runs_the_collectives(tmp_path):
    import torch.distributed as dist
    from sednet_tpu_torch.parallel import dryrun
    from sednet_tpu_torch.parallel.mesh import COLLECTIVES, init_mesh

    cpu = torch.device("cpu")
    cfg = dryrun._config(1)
    one = dryrun._step(dryrun._model(cfg, cpu), cfg, None, cpu)
    mesh = init_mesh(0, 1, str(tmp_path), device="cpu")
    try:
        before = dict(COLLECTIVES)
        got = dryrun._step(dryrun._model(cfg, cpu), cfg, mesh, cpu)
    finally:
        dist.destroy_process_group()
    assert COLLECTIVES["all_gather"] > before["all_gather"]
    assert COLLECTIVES["all_reduce"] == before["all_reduce"] + 1
    assert got[0] == one[0]
    for k in one[1]:
        np.testing.assert_array_equal(got[1][k], one[1][k])
