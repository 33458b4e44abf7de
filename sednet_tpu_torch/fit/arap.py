"""As-rigid-as-possible deformation of a predicted spline grid to the input
cloud — the refinement step before the Kronecker B-spline refit.

Rebuild of the reference's Arap (reference: src/fitting_optimization.py:32-114),
which wraps open3d's `deform_as_rigid_as_possible`: the predicted (u x v)
surface grid is tessellated, its u-boundary vertices (j == 0 and j == v-1
columns, reference get_boundary_indices :86-93) become handles pinned to
Hungarian-matched input points (reference define_matching :104-114, matching
against a 1.2x random subsample), and the mesh is deformed with hard handle
constraints. This is the standard Sorkine-Alexa 2007 local-global ARAP:
per-vertex rotation fitting (SVD of the one-ring covariance) alternating with
a prefactored sparse cotan-Laplacian solve — host-side scipy, matching the
reference's CPU/open3d placement of this step. A copy of
`sednet_tpu/fit/arap.py`.
"""
from __future__ import annotations

import numpy as np


def grid_triangles(size_u: int, size_v: int) -> np.ndarray:
    """Triangulation of a (size_u x size_v) vertex grid, row-major (i, j) ->
    i * size_v + j (the reference's tessalate_points connectivity,
    src/VisUtils.py:163-175)."""
    tris = []
    for i in range(size_u - 1):
        for j in range(size_v - 1):
            a = i * size_v + j
            b = a + size_v
            # same quad diagonal (a, b+1) as utils/mesh.tessellate_points
            # and fit/surfaces.tessellate_points_fast — one triangulation
            # convention across the package
            tris.append((a, b, b + 1))
            tris.append((a, b + 1, a + 1))
    return np.asarray(tris, np.int64)


def boundary_indices(size_u: int, size_v: int) -> np.ndarray:
    """The j == 0 and j == size_v - 1 columns (reference:
    src/fitting_optimization.py:86-93)."""
    idx = []
    for i in range(size_u):
        idx.append(i * size_v)
        idx.append(i * size_v + size_v - 1)
    return np.asarray(sorted(idx), np.int64)


def _cotan_weights(verts: np.ndarray, tris: np.ndarray):
    """Symmetric per-edge cotangent weights, clamped >= 1e-3 (degenerate
    tris would destabilize the solve)."""
    from collections import defaultdict

    w = defaultdict(float)
    for a, b, c in tris:
        pa, pb, pc = verts[a], verts[b], verts[c]
        for (i, j, k) in ((a, b, c), (b, c, a), (c, a, b)):
            u = verts[j] - verts[k]
            v = verts[i] - verts[k]
            cos = float(u @ v)
            sin = float(np.linalg.norm(np.cross(u, v)))
            cot = cos / max(sin, 1e-9)
            e = (i, j) if i < j else (j, i)
            w[e] += 0.5 * cot
    edges = np.asarray(list(w.keys()), np.int64)
    weights = np.maximum(np.asarray(list(w.values()), float), 1e-3)
    return edges, weights


def match_targets(recon: np.ndarray, input_points: np.ndarray,
                  rng: np.random.RandomState | None = None) -> np.ndarray:
    """Hungarian match every recon vertex to an input point drawn from a
    1.2x random subsample (reference define_matching,
    src/fitting_optimization.py:104-114)."""
    from scipy.optimize import linear_sum_assignment

    rng = rng or np.random.RandomState(0)
    m = int(1.2 * recon.shape[0])
    replace = input_points.shape[0] < m
    sel = rng.choice(input_points.shape[0], m, replace=replace)
    sub = input_points[sel]
    dist = np.linalg.norm(recon[:, None] - sub[None], axis=2)
    _, cids = linear_sum_assignment(dist)
    return sub[cids]


def arap_deform(grid_points: np.ndarray, input_points: np.ndarray,
                size_u: int, size_v: int, *, iters: int = 30,
                rng: np.random.RandomState | None = None) -> np.ndarray:
    """Deform the (size_u * size_v, 3) grid so its u-boundary columns move
    to Hungarian-matched input points, as rigidly as possible elsewhere
    (reference Arap.deform, src/fitting_optimization.py:49-83; open3d's
    max_iter=500 hard-constraint solve becomes `iters` local-global rounds
    on a prefactored reduced Laplacian)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    p0 = np.asarray(grid_points, float).reshape(-1, 3)
    n = p0.shape[0]
    assert n == size_u * size_v, (n, size_u, size_v)
    tris = grid_triangles(size_u, size_v)
    edges, w = _cotan_weights(p0, tris)

    handles = boundary_indices(size_u, size_v)
    # full-grid Hungarian like the reference define_matching
    # (fitting_optimization.py:106-114 matches every output vertex);
    # only the boundary handles' rows become hard constraints
    matched = match_targets(p0, np.asarray(input_points, float), rng)
    targets = matched[handles]

    free = np.setdiff1d(np.arange(n), handles)
    pos_of_free = -np.ones(n, np.int64)
    pos_of_free[free] = np.arange(free.shape[0])

    # Laplacian L = D - W over all vertices
    i0, i1 = edges[:, 0], edges[:, 1]
    rows = np.concatenate([i0, i1, i0, i1])
    cols = np.concatenate([i1, i0, i0, i1])
    vals = np.concatenate([-w, -w, w, w])
    L = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    L_ff = L[free][:, free].tocsc()
    L_fc = L[free][:, handles]
    solver = spla.factorized(L_ff)

    p = p0.copy()
    p[handles] = targets
    # per-vertex incident edge lists for the local rotation step
    e_all = np.concatenate([edges, edges[:, ::-1]])       # directed both ways
    w_all = np.concatenate([w, w])
    order = np.argsort(e_all[:, 0], kind="stable")
    e_all, w_all = e_all[order], w_all[order]
    starts = np.searchsorted(e_all[:, 0], np.arange(n + 1))
    rest = p0[e_all[:, 0]] - p0[e_all[:, 1]]              # rest-pose edges

    for _ in range(iters):
        cur = p[e_all[:, 0]] - p[e_all[:, 1]]
        # covariance S_i = sum_j w_ij e0_ij e1_ij^T per vertex
        outer = (w_all[:, None, None] * rest[:, :, None] * cur[:, None, :])
        S = np.add.reduceat(outer, starts[:-1], axis=0)
        # rotation mapping rest -> current edges: S = U Sigma V^T, R = V U^T
        # (reflections fixed by flipping V's least-significant column)
        U, _, Vt = np.linalg.svd(S)
        R = np.matmul(Vt.transpose(0, 2, 1), U.transpose(0, 2, 1))
        neg = np.linalg.det(R) < 0
        Vt[neg, -1, :] *= -1.0
        R = np.matmul(Vt.transpose(0, 2, 1), U.transpose(0, 2, 1))
        # rhs: b_i = sum_j w_ij/2 (R_i + R_j) (p0_i - p0_j)
        Ri = R[e_all[:, 0]]
        Rj = R[e_all[:, 1]]
        rot_e = np.einsum("nij,nj->ni", 0.5 * (Ri + Rj), rest)
        b = np.add.reduceat(w_all[:, None] * rot_e, starts[:-1], axis=0)
        rhs = b[free] - L_fc @ targets
        p_free = np.column_stack([solver(rhs[:, k]) for k in range(3)])
        p = p.copy()
        p[free] = p_free
        p[handles] = targets
    return p
