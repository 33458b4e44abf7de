"""The port's spans and counts (`sednet_tpu_torch.utils.tracing`): what a
CPU profile of the eval stream and of the train step behind its prefetch
loader exports, each count against the number it stands for, nothing
entered without a profiler, and the same bits with tracing on and off."""
import importlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sednet_tpu_torch.config as cfg_port
import sednet_tpu_torch.predict as predict_port
from sednet_tpu_torch import train as ttrain
from sednet_tpu_torch.cluster import spectral
from sednet_tpu_torch.data import datasets as tdata
from sednet_tpu_torch.data import make_synthetic_shape
from sednet_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "bench_10k.npz")
# the module (the package's `mean_shift` name is the function)
ms = importlib.import_module("sednet_tpu_torch.cluster.mean_shift")

STREAM_SPANS = {f"predict_shapes/{s}" for s in (
    "type_forward", "inst_forward", "affinity", "lobpcg", "entropy_concat",
    "cluster_batch", "metrics")}
STREAM_COUNTS = ("cluster/ms_steps_run", "cluster/ms_steps_needed",
                 "cluster/guard_retries", "lobpcg/iterations",
                 "lobpcg/replayed")
TRAIN_SPANS = {"train_step/forward_loss", "train_step/backward",
               "train_step/optimizer", "train/to_device",
               "data/prefetch_wait"}
MAIN = "test/main"   # a range the test opens on its own thread


def exported(prof, path) -> list:
    """The (name, tid) of each host range in prof's Chrome export."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e.get("tid")) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def counted(ranges, name) -> list:
    prefix = name + "="
    return [int(n[len(prefix):]) for n, _ in ranges if n.startswith(prefix)]


def profiled(fn, path):
    """fn() under a CPU profile, inside a range `MAIN`: (its result, the
    exported ranges, the main thread's tid)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(MAIN):
            out = fn()
    ranges = exported(prof, path)
    return out, ranges, next(t for n, t in ranges if n == MAIN)


# --- the helper -----------------------------------------------------------

def test_span_and_count_enter_no_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not tracing.tracing_on()
    for _ in range(3):
        with tracing.span("a"):
            pass
        tracing.count("b", 7)
        with tracing.trace("c"):
            pass
    loader = tdata.PrefetchLoader([{"i": np.array([i])} for i in range(3)])
    assert [int(b["i"][0]) for b in loader] == [0, 1, 2]
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            tracing.count("b", 7.9)
    assert entered == ["a", "b=7"]


def test_count_is_a_range_named_by_its_value_inside_the_span(tmp_path):
    def body():
        with tracing.span("outer"):
            tracing.count("n", 3)
            tracing.count("n", 0)

    _, ranges, tid = profiled(body, tmp_path / "t.json")
    assert ("outer", tid) in ranges
    assert sorted(counted(ranges, "n")) == [0, 3]
    assert all(t == tid for n, t in ranges if n.startswith("n="))


# --- the eval stream --------------------------------------------------------

def _stream_inputs():
    shapes, _ = predict_port.headline_shapes(4, 128)
    batches = [{k: np.stack([s[k] for s in shapes[i:i + 2]])
                for k in ("points", "normals", "labels", "prim")}
               for i in (0, 2)]
    cfg = cfg_port.Config(num_points=128, knn=16, hpnet_embed=True)
    return batches, cfg, predict_port.load_models(CKPT, cfg, device="cpu")


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    """The stream over two batches without a profiler and under one: its
    results each time, the exported ranges and the main thread's tid, and
    the iterations each LOBPCG solve returned under the profiler."""
    batches, cfg, models = _stream_inputs()

    def run():
        return list(predict_port.predict_shapes_stream(
            models["type"], models["inst"], iter(batches), cfg, seed=11))

    plain = run()
    solve, its = spectral.lobpcg_standard, []

    def recording(*a, **k):
        out = solve(*a, **k)
        its.append(int(out[2]))
        return out

    spectral.lobpcg_standard = recording
    try:
        traced, ranges, tid = profiled(
            run, tmp_path_factory.mktemp("stream") / "t.json")
    finally:
        spectral.lobpcg_standard = solve
    return {"plain": plain, "traced": traced, "ranges": ranges, "tid": tid,
            "its": its, "cfg": cfg}


def test_stream_exports_its_spans_and_counts(stream_runs):
    ranges, tid = stream_runs["ranges"], stream_runs["tid"]
    assert STREAM_SPANS <= {n for n, t in ranges if t == tid}
    for name in STREAM_COUNTS:
        values = [int(n.split("=", 1)[1]) for n, t in ranges
                  if n.startswith(name + "=") and t == tid]
        # one a batch, one LOBPCG solve a shape
        assert len(values) == (4 if name.startswith("lobpcg/") else 2), name
    iters = stream_runs["cfg"].ms_iterations
    run = counted(ranges, "cluster/ms_steps_run")
    needed = counted(ranges, "cluster/ms_steps_needed")
    assert run == [iters, iters]
    assert all(1 <= n <= iters for n in needed)


def test_stream_results_are_the_same_bits_traced(stream_runs):
    assert len(stream_runs["plain"]) == len(stream_runs["traced"]) == 2
    for got, want in zip(stream_runs["traced"], stream_runs["plain"]):
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for name in g:
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_lobpcg_iterations_count_is_what_the_solve_returned(stream_runs):
    assert counted(stream_runs["ranges"], "lobpcg/iterations") == \
        stream_runs["its"]
    assert all(1 <= i <= 10 for i in stream_runs["its"])


def test_stream_solves_each_cloud_once_through_the_module_global(
        stream_runs):
    # `top_eigvecs` looks `lobpcg_standard` up in `cluster.spectral` at each
    # call (what a hook rebinding it sees): one call a cloud, 2 x 2 clouds
    assert len(stream_runs["its"]) == 4
    # the CPU solves eagerly: no iteration is replayed
    assert counted(stream_runs["ranges"], "lobpcg/replayed") == [0] * 4


def test_top_eigvecs_counts_each_solve(tmp_path, monkeypatch):
    g = torch.Generator().manual_seed(0)
    m = torch.randn(60, 60, generator=g)
    a = m @ m.T
    solve, its = spectral.lobpcg_standard, []

    def recording(*args, **k):
        out = solve(*args, **k)
        its.append(out[2])
        return out

    monkeypatch.setattr(spectral, "lobpcg_standard", recording)
    _, ranges, _ = profiled(lambda: [spectral.top_eigvecs(
        a, 60, "cpu", generator=g, k=4, iters=iters) for iters in (1, 10)],
        tmp_path / "t.json")
    assert its[0] == 1
    assert counted(ranges, "lobpcg/iterations") == its


def _solve_before_replay(a, x, m, tol=None):
    """`cluster/lobpcg.py lobpcg_standard` as it stood before its steps
    became generators and its iteration a CUDA-graph replay on the card:
    the reference whose bits the CPU solve keeps."""
    def norms(x):
        return torch.linalg.vector_norm(x, dim=0, keepdim=True)

    def eigh_desc(a):
        w, v = torch.linalg.eigh(a)
        return w.flip(0), v.flip(1)

    def svqb(x):
        nx = norms(x)
        x = x / torch.where(nx == 0, 1.0, nx)
        inner = x.T @ x
        w, v = eigh_desc(inner)
        tau = torch.finfo(x.dtype).eps * w[0]
        padded = torch.maximum(w, tau)
        sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
        ortho = x @ (v * sqrted[None, :])
        keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
        ortho = ortho * keep.to(ortho.dtype)
        no = norms(ortho)
        keep = keep & (no > 0.0)
        return ortho / torch.where(keep, no, 1.0)

    def orth(b):
        return svqb(svqb(b))

    def project_out(basis, u):
        for _ in range(2):
            u = orth(u - basis @ (basis.T @ u))
        for _ in range(2):
            u = u - basis @ (basis.T @ u)
        return u * (norms(u) >= 0.99).to(u.dtype)

    def extend(x, m):
        n, k = x.shape
        upper, lower = x[:k], x[k:]
        u, s, vt = torch.linalg.svd(upper)
        y = torch.cat([upper + u @ vt, lower], 0)
        other = torch.cat([torch.eye(m), torch.zeros((n - k - m, m))], 0)
        w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
        h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
        h[k:] += other
        return h

    matvec = a if callable(a) else (lambda v: a @ v)
    n, k = x.shape
    tol = float(torch.finfo(x.dtype).eps) if tol is None else tol
    x = orth(x)
    p = extend(x, k)
    ax = matvec(x)
    theta = (x * ax).sum(0, keepdim=True)
    r = ax - theta * x
    i, converged = 0, 0
    while i < m and converged < k:
        r = project_out(torch.cat((x, p), 1), r)
        xpr = torch.cat((x, p, r), 1)
        theta, q = eigh_desc(xpr.T @ matvec(xpr))
        b = q[:, :k]
        x = xpr @ (b / norms(b))
        x = x / norms(x)
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = matvec(x)
        r = ax - theta[None, :k] * x
        resid = torch.linalg.vector_norm(r, dim=0)
        reltol = (torch.linalg.vector_norm(ax, dim=0) + theta[:k]) * n * 10
        converged = int((resid < tol * reltol).sum())
        theta = theta[None, :k]
        i += 1
    return theta[0], x, i


@pytest.mark.parametrize("n,k,m,dense", [(300, 12, 10, True),
                                         (300, 12, 10, False),
                                         (500, 8, 100, True),
                                         (60, 4, 0, True)])
def test_cpu_solve_is_the_loop_before_replay(n, k, m, dense, tmp_path):
    from sednet_tpu_torch.cluster import lobpcg

    g = torch.Generator().manual_seed(n + k)
    b = torch.randn(n, n, generator=g)
    a = b @ b.T / n
    x0 = torch.randn(n, k, generator=g)
    op = a if dense else (lambda v: a @ v)
    want = _solve_before_replay(op, x0, m)
    # the same key twice: the second solve of a key would capture on the card
    solves, ranges, _ = profiled(
        lambda: [lobpcg.lobpcg_standard(op, x0, m=m) for _ in range(2)],
        tmp_path / "t.json")
    for theta, u, its in solves:
        assert its == want[2]
        assert torch.equal(theta, want[0]) and torch.equal(u, want[1])
    assert counted(ranges, "lobpcg/replayed") == [0, 0]
    assert not lobpcg._REPLAYS.replays and not lobpcg._REPLAYS.seen


def test_replays_capture_at_a_keys_second_solve_and_drop_the_oldest(
        monkeypatch):
    from sednet_tpu_torch.cluster import lobpcg

    made = []

    class Captured:
        def __init__(self, a, x, p, r, tol):
            if a.shape[0] == 13:
                raise RuntimeError("operation not permitted when capturing")
            made.append(x.shape)

    monkeypatch.setattr(lobpcg, "_Replay", Captured)
    cache = lobpcg._Replays(size=2)

    def get(n):
        x = torch.zeros(n, 2)
        return cache.get(torch.zeros(n, n), x, x, x, 1e-7)

    assert get(10) is None and made == []
    first = get(10)
    assert isinstance(first, Captured) and made == [(10, 2)]
    assert get(10) is first and len(made) == 1
    assert get(11) is None and isinstance(get(11), Captured)
    assert get(12) is None and isinstance(get(12), Captured)
    # 10 was the least recently used of three
    assert [key[1] for key in cache.replays] == [11, 12]
    assert get(10) is None and isinstance(get(10), Captured)
    # a failed capture leaves the key eager, and is not tried again
    assert get(13) is None and get(13) is None
    assert get(13) is None and len(made) == 4
    assert [key[1] for key in cache.failed] == [13]


# --- the clustering's counts ------------------------------------------------

def _clouds(b, n, e, centers, spread, seed):
    """b clouds of n unit rows of width e about `centers` random
    directions each."""
    g = torch.Generator().manual_seed(seed)
    c = torch.nn.functional.normalize(torch.randn(b, centers, e, generator=g),
                                      dim=-1)
    pick = torch.randint(0, centers, (b, n), generator=g)
    x = torch.gather(c, 1, pick[..., None].expand(b, n, e))
    x = x + spread * torch.randn(b, n, e, generator=g)
    return torch.nn.functional.normalize(x, dim=-1)


@pytest.mark.parametrize("tol", [1e-3, 1e-6, 0.0])
def test_ms_steps_needed_is_the_host_loops_exit(tol, tmp_path):
    x = _clouds(2, 96, 16, 3, 0.05, seed=1)
    kw = {"num_samples": 96, "iterations": 30, "tol": tol}

    def both_halves():
        p = ms.cluster_batch_async(
            x, generator=torch.Generator().manual_seed(2), **kw)
        ms.cluster_batch_finalize(p, **kw)
        return p

    pending, ranges, _ = profiled(both_halves, tmp_path / "t.json")
    # the same steps on the host, stopping at `_iterate_until`'s exit
    start, cols = ms._step_inputs(pending.x, pending.width, False)
    steps = []

    def step(cur):
        steps.append(1)
        return ms.mean_shift_step_batched(cur, cols, pending.bandwidth)

    host = ms._iterate_until(step, start, 30, tol)
    assert counted(ranges, "cluster/ms_steps_run") == [30]
    assert counted(ranges, "cluster/ms_steps_needed") == [len(steps)]
    if tol >= 1e-3:
        assert len(steps) < 30
    torch.testing.assert_close(pending.shifted[..., :16], host[..., :16],
                               rtol=0, atol=0)


def test_guard_retries_count_is_the_guards_attempts(tmp_path, monkeypatch):
    x = _clouds(3, 96, 16, 6, 0.02, seed=3)
    attempts = []
    real = ms.mean_shift

    def counting(*a, **k):
        attempts.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ms, "mean_shift", counting)
    (labels, nums, flags), ranges, _ = profiled(
        lambda: ms.cluster_batch(x, num_samples=96, quantile=0.05,
                                 iterations=20, max_clusters=2,
                                 generator=torch.Generator().manual_seed(4)),
        tmp_path / "t.json")
    assert len(attempts) > 0
    assert counted(ranges, "cluster/guard_retries") == [len(attempts)]
    assert (nums <= 2).all()
    # no retry: the count reads 0
    attempts.clear()
    _, ranges, _ = profiled(
        lambda: ms.cluster_batch(x, num_samples=96, quantile=0.05,
                                 iterations=20, max_clusters=49,
                                 generator=torch.Generator().manual_seed(4)),
        tmp_path / "u.json")
    assert attempts == []
    assert counted(ranges, "cluster/guard_retries") == [0]


# --- the train step behind its prefetch loader ------------------------------

TRAIN_N, TRAIN_B = 128, 2
TRAIN_CFG = dict(num_points=TRAIN_N, knn=8, embed=16, batch_size=TRAIN_B,
                 edge_topk=TRAIN_N, ms_max_clusters=12, seed=3)


def _train_steps(steps: int = 2):
    """`steps` train steps of a fresh model (the same init every call) fed
    by `PrefetchLoader`: (the losses, the parameters after)."""
    cfg = cfg_port.Config(**TRAIN_CFG)
    model = ttrain.init_like_flax(ttrain.build_model(cfg),
                                  torch.Generator().manual_seed(0))
    optimizer = ttrain.make_optimizer(cfg, model.parameters())
    step = ttrain.make_train_step(model, optimizer, cfg)
    rng = np.random.RandomState(5)
    raw = [make_synthetic_shape(rng, n_points=TRAIN_N, n_segments=4)
           for _ in range(TRAIN_B * steps)]
    a = {k: np.stack([d[k] for d in raw]) for k in
         ("points", "labels", "normals", "prim", "edges", "edges_w")}
    ds = tdata._H5Dataset(a["points"], a["labels"], a["normals"], a["prim"],
                          a["edges"], a["edges_w"], train=True,
                          num_points=TRAIN_N, max_segments=12, seed=6)
    draws = torch.Generator().manual_seed(7)
    losses = []
    for hb in tdata.PrefetchLoader(tdata.BatchLoader(ds, TRAIN_B,
                                                     shuffle=False)):
        m = step(ttrain.to_device(hb, "cpu"), generator=draws)
        losses.append(m["loss"].clone())
    return losses, {k: v.detach().clone()
                    for k, v in model.named_parameters()}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    plain = _train_steps()
    traced, ranges, tid = profiled(
        _train_steps, tmp_path_factory.mktemp("train") / "t.json")
    return {"plain": plain, "traced": traced, "ranges": ranges, "tid": tid}


def test_train_step_exports_its_spans_and_the_loaders_count(train_runs):
    ranges, tid = train_runs["ranges"], train_runs["tid"]
    names = [n for n, t in ranges if t == tid]
    assert TRAIN_SPANS <= set(names)
    for span in ("train_step/forward_loss", "train_step/backward",
                 "train/to_device"):
        assert names.count(span) == 2, span
    # the zero-fill and the update are two spans a step
    assert names.count("train_step/optimizer") == 4
    # the loop takes two batches; the end of the queue is one more wait
    assert names.count("data/prefetch_wait") == 3
    us = [int(n.split("=", 1)[1]) for n in names
          if n.startswith("data/assemble_us=")]
    assert len(us) == 2 and all(u >= 0 for u in us)


def test_train_step_is_the_same_bits_traced(train_runs):
    (lp, pp), (lt, pt) = train_runs["plain"], train_runs["traced"]
    assert len(lp) == len(lt) == 2
    for a, b in zip(lp, lt):
        assert torch.equal(a, b)
    assert pp.keys() == pt.keys()
    for k in pp:
        assert torch.equal(pp[k], pt[k]), k
