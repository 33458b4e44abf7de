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
"""
from __future__ import annotations

import torch


def _eigh_descending(a):
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def _col_norms(x):
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _svqb(x):
    """Truncated orthonormal basis of the columns of x (zero columns where
    x is rank-deficient)."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
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
        basis = _svqb(basis)
    return basis


def _project_out(basis, u):
    """The component of u orthogonal to the orthonormal `basis`, with
    orthonormal nonzero columns; suspicious columns are zeroed."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99).to(u.dtype)


def _rayleigh_ritz_orth(matvec, s):
    return _eigh_descending(s.T @ matvec(s))


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


def lobpcg_standard(a, x, m: int = 100, tol: float | None = None):
    """Top-k eigenpairs of the symmetric a (n, n) (a tensor or a callable
    v -> a @ v) from the start block x (n, k), k * 5 < n, in at most m
    iterations. Returns (theta (k,), U (n, k), iterations)."""
    matvec = a if callable(a) else (lambda v: a @ v)
    n, k = x.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"expected 0 < search dim * 5 < matrix dim "
                         f"(got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(x.dtype).eps)

    x = _orthonormalize(x)
    p = _extend_basis(x, x.shape[1])
    ax = matvec(x)
    theta = (x * ax).sum(0, keepdim=True)
    r = ax - theta * x

    i, converged = 0, 0
    while i < m and converged < k:
        r = _project_out(torch.cat((x, p), 1), r)
        xpr = torch.cat((x, p, r), 1)
        theta, q = _rayleigh_ritz_orth(matvec, xpr)

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
        converged = int((resid < tol * reltol).sum())
        theta = theta[None, :k]
        i += 1
    return theta[0], x, i
