"""Top-k eigenpairs of a symmetric matrix by LOBPCG, in PyTorch.

The port's own copy of `jax.experimental.sparse.linalg.lobpcg_standard` as
JAX 0.9.0 has it (its `linalg.py:37-515`), which the JAX package's spectral
enrichment calls: an orthonormal block [X, P, R] kept by SVQB
orthonormalisation (`_svqb`, twice), residuals projected out of [X, P]
("twice is enough", then two more subtractions and a 0.99 norm cut),
Rayleigh-Ritz on the block, a deterministic Householder extension of the
start basis for P, and the convergence test |r| < eps * 10 n (theta + |AX|).
`torch.lobpcg` is another solver and gives other iterates.

Everything stays float32 (TF32 is off in the package). Each eigenvector is
defined only up to sign, and the small `eigh`/`svd`/`qr` calls choose signs
differently on LAPACK and cuSOLVER, so results are compared per column up
to sign; what uses them downstream (ranges, distances, mean-shift) is
invariant under a column's sign.

The steps are generators that yield each small symmetric matrix whose
`torch.linalg.eigh` they need and take its eigenpairs back: `_run` answers
them eagerly. On the card an iteration on a dense operator is replayed as
CUDA graphs (`_Replay`): the graphs hold every launch between two `eigh`
calls, and each `eigh`, which reads its error code back to the host, runs
eagerly between them on the graphs' own buffers. The replayed kernels are
the eager ones on the same inputs, so a replayed solve gives the eager
solve's bits. A (device, n, k, tol) is captured at its second solve
(`_Replays`); its first runs eagerly, as does every solve on the CPU or of
a callable operator.
"""
from __future__ import annotations

import collections
import logging
import threading

import torch

from sednet_tpu_torch.utils.tracing import count

logger = logging.getLogger(__name__)


def _eigh_descending(a):
    """The eigenpairs of the symmetric a, largest first: yields a and
    takes back `torch.linalg.eigh(a)`."""
    w, v = yield a
    return w.flip(0), v.flip(1)


def _run(steps):
    """Drive a generator of steps eagerly, answering each matrix it yields
    with `torch.linalg.eigh`; returns its value."""
    try:
        a = next(steps)
        while True:
            a = steps.send(torch.linalg.eigh(a))
    except StopIteration as done:
        return done.value


def _col_norms(x):
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _svqb(x):
    """Truncated orthonormal basis of the columns of x (zero columns where
    x is rank-deficient)."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = yield from _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):
        basis = yield from _svqb(basis)
    return basis


def _project_out(basis, u):
    """The component of u orthogonal to the orthonormal `basis`, with
    orthonormal nonzero columns; suspicious columns are zeroed."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = yield from _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99).to(u.dtype)


def _rayleigh_ritz_orth(matvec, s):
    return (yield from _eigh_descending(s.T @ matvec(s)))


def _extend_basis(x, m: int):
    """m more orthonormal columns for the orthonormal x (n, k), by a block
    Householder reflector (deterministic)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], 0)
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype,
                                   device=x.device)], 0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h


def _iteration(matvec, x, p, r, tol: float):
    """One LOBPCG iteration from the block (x, p, r): steps that return
    (theta (1, k), x, p, r, the count of converged columns as a tensor)."""
    n, k = x.shape
    r = yield from _project_out(torch.cat((x, p), 1), r)
    xpr = torch.cat((x, p, r), 1)
    theta, q = yield from _rayleigh_ritz_orth(matvec, xpr)

    b = q[:, :k]
    b = b / _col_norms(b)
    x = xpr @ b
    x = x / _col_norms(x)

    qq, _ = torch.linalg.qr(q[:k, k:].T)
    p = xpr @ (q[:, k:] @ qq)
    norm_p = _col_norms(p)
    p = p / torch.where(norm_p == 0, 1.0, norm_p)

    ax = matvec(x)
    r = ax - theta[None, :k] * x
    resid = torch.linalg.vector_norm(r, dim=0)
    reltol = (torch.linalg.vector_norm(ax, dim=0) + theta[:k]) * n * 10
    return theta[None, :k], x, p, r, (resid < tol * reltol).sum()


class _Replay:
    """The iteration on a dense operator of one (device, n, k, tol),
    captured as CUDA graphs: `graphs[j]` runs every launch from the end of
    the j-th `eigh` to the next, whose matrix it leaves in `asks[j]`;
    `torch.linalg.eigh(asks[j], out=answers[j])` runs eagerly between
    `graphs[j]` and `graphs[j + 1]`. The graphs read the operator and the
    block from static buffers, and the last one writes the block, theta
    and the converged count back into them."""

    def __init__(self, a, x, p, r, tol: float):
        self.a = torch.empty_like(a)
        self.block = [torch.empty_like(t) for t in (x, p, r)]
        self.theta = torch.empty_like(x[:1])
        self.converged = torch.zeros((), dtype=torch.int64, device=a.device)
        self.lock = threading.Lock()
        self.graphs, self.asks, self.answers = [], [], []
        with torch.cuda.device(a.device):
            self._load(a, x, p, r)
            self._capture(tol)

    def _load(self, a, x, p, r):
        self.a.copy_(a)
        for dst, src in zip(self.block, (x, p, r)):
            dst.copy_(src)

    def _capture(self, tol: float):
        dev = self.a.device

        def matvec(v):
            return self.a @ v

        x, p, r = self.block
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # an eager iteration on this stream first: its cuBLAS and
            # cuSOLVER workspaces then exist before the capture
            _run(_iteration(matvec, x, p, r, tol))
            steps = _iteration(matvec, x, p, r, tol)
            answer, pool = None, None
            while True:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    ask = steps.send(answer)
                except StopIteration as done:
                    ask = None
                    for dst, src in zip((self.theta, *self.block,
                                         self.converged), done.value):
                        dst.copy_(src)
                finally:
                    g.capture_end()
                pool = g.pool()
                self.graphs.append(g)
                if ask is None:
                    break
                # buffers laid out as an eager eigh lays out its result
                answer = tuple(torch.linalg.eigh(torch.eye(
                    ask.shape[0], dtype=ask.dtype, device=dev)))
                self.asks.append(ask)
                self.answers.append(answer)
        torch.cuda.current_stream(dev).wait_stream(side)

    def solve(self, a, x, p, r, m: int):
        """Iterate from the block (x, p, r) on the operator a, as the eager
        loop does: (theta (k,), x, iterations), the caller's own tensors."""
        k = x.shape[1]
        with torch.cuda.device(self.a.device):
            self._load(a, x, p, r)
            i, converged = 0, 0
            while i < m and converged < k:
                for g, ask, answer in zip(self.graphs, self.asks,
                                          self.answers):
                    g.replay()
                    torch.linalg.eigh(ask, out=answer)
                self.graphs[-1].replay()
                converged = int(self.converged)
                i += 1
        return self.theta[0].clone(), self.block[0].clone(), i


class _Replays:
    """The captured iterations by (device, n, k, tol): a key's first solve
    runs eagerly, its second captures, and at most `size` keys are kept,
    the least recently used dropped first. A key whose capture failed runs
    eagerly from then on."""

    seen_size = 64      # keys seen once that are remembered

    def __init__(self, size: int = 4):
        self.size = size
        self.lock = threading.Lock()
        self.clear()

    def clear(self):
        with self.lock:
            self.seen = collections.OrderedDict()
            self.replays = collections.OrderedDict()
            self.failed = set()

    def get(self, a, x, p, r, tol: float):
        """The replay for this solve, captured now at the key's second
        solve; None where the solve runs eagerly."""
        key = (a.device, *x.shape, tol)
        with self.lock:
            if key in self.replays:
                self.replays.move_to_end(key)
                return self.replays[key]
            if key in self.failed:
                return None
            if key not in self.seen:
                self.seen[key] = None
                while len(self.seen) > self.seen_size:
                    self.seen.popitem(last=False)
                return None
            del self.seen[key]
        try:
            replay = _Replay(a, x, p, r, tol)
        except RuntimeError:
            logger.warning("LOBPCG capture failed for %s; solving eagerly",
                           key, exc_info=True)
            with self.lock:
                self.failed.add(key)
            return None
        with self.lock:
            self.replays[key] = replay
            while len(self.replays) > self.size:
                self.replays.popitem(last=False)
        return replay


_REPLAYS = _Replays()


def _replayable(a, x) -> bool:
    """A dense float32 operator and block on the card, laid out as the
    eager loop lays out its own."""
    return (isinstance(a, torch.Tensor) and a.is_cuda
            and a.dtype == x.dtype == torch.float32
            and a.is_contiguous() and x.device == a.device)


def lobpcg_standard(a, x, m: int = 100, tol: float | None = None):
    """Top-k eigenpairs of the symmetric a (n, n) (a tensor or a callable
    v -> a @ v) from the start block x (n, k), k * 5 < n, in at most m
    iterations. Returns (theta (k,), U (n, k), iterations). While a
    profiler runs, the iterations run by CUDA-graph replay are the count
    `lobpcg/replayed`."""
    matvec = a if callable(a) else (lambda v: a @ v)
    n, k = x.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"expected 0 < search dim * 5 < matrix dim "
                         f"(got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(x.dtype).eps)

    x = _run(_orthonormalize(x))
    p = _extend_basis(x, x.shape[1])
    ax = matvec(x)
    theta = (x * ax).sum(0, keepdim=True)
    r = ax - theta * x

    replay = (_REPLAYS.get(a, x, p, r, tol)
              if m > 0 and _replayable(a, x) else None)
    if replay is not None and replay.lock.acquire(blocking=False):
        try:
            theta, x, i = replay.solve(a, x, p, r, m)
        finally:
            replay.lock.release()
        count("lobpcg/replayed", i)
        return theta, x, i

    i, converged = 0, 0
    while i < m and converged < k:
        theta, x, p, r, conv = _run(_iteration(matvec, x, p, r, tol))
        converged = int(conv)
        i += 1
    count("lobpcg/replayed", 0)
    return theta[0], x, i
