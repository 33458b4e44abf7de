"""The port's fit layer (sednet_tpu_torch.fit: primitives, residuals,
bspline and the numpy copies) against the JAX package's on the CPU, on the
same seeded inputs.

Tolerances: own-type fit parameters at atol 2e-4 after the sign
canonicalisation `_canon` states (float32 SVDs and solves through two
LAPACK call paths), padding with zero weight at atol 1e-5, distances and
residuals at rtol 1e-5, the B-spline math at atol 1e-6, the numpy copies
exactly, standardisation's rotation at atol 1e-5 and its points at 1e-4
(the extent of a thin cloud's short axis divides them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.data.synthetic import (sample_cone, sample_cylinder,
                                       sample_plane, sample_sphere)
from sednet_tpu.fit import arap as jarap
from sednet_tpu.fit import bspline as jbs
from sednet_tpu.fit import primitives as jprim
from sednet_tpu.fit import residuals as jres
from sednet_tpu.fit import samplers as jsmp
from sednet_tpu.fit import surfaces as jsurf
from sednet_tpu_torch.fit import arap as tarap
from sednet_tpu_torch.fit import bspline as tbs
from sednet_tpu_torch.fit import primitives as tprim
from sednet_tpu_torch.fit import residuals as tres
from sednet_tpu_torch.fit import samplers as tsmp
from sednet_tpu_torch.fit import surfaces as tsurf

SAMPLERS = {"plane": sample_plane, "sphere": sample_sphere,
            "cylinder": sample_cylinder, "cone": sample_cone}
SLOTS = {"plane": slice(0, 4), "sphere": slice(4, 8),
         "cylinder": slice(8, 15), "cone": slice(15, 22)}


def _segments(seed, sizes=(50, 300, 1000)):
    """Noisy seeded segments of every type with random weights: a list of
    (name, points, normals, weights), float32."""
    rng = np.random.RandomState(seed)
    out = []
    for name, fn in SAMPLERS.items():
        for n in sizes:
            p, nrm, _ = fn(rng, n)
            p = p + rng.randn(*p.shape) * 0.005
            out.append((name, p.astype(np.float32), nrm.astype(np.float32),
                        rng.uniform(0.2, 1.0, n).astype(np.float32)))
    return out


def _padded(segs, extra=0):
    p_max = max(s[1].shape[0] for s in segs) + extra
    pts = np.zeros((len(segs), p_max, 3), np.float32)
    nrm = np.zeros_like(pts)
    w = np.zeros((len(segs), p_max), np.float32)
    for i, (_, p, n, ww) in enumerate(segs):
        pts[i, :len(p)], nrm[i, :len(p)], w[i, :len(p)] = p, n, ww
    return pts, nrm, w


def _canon(row, name):
    """A segment's own-type slot of a packed (22,) fit, with the signs no
    distance sees fixed: the plane's (n, d) and the cylinder's axis turned
    so that their largest axis component is positive; the cylinder's
    centre reduced to its component across the axis (its axial component
    is pinned only by the ridge term)."""
    v = np.asarray(row[SLOTS[name]], np.float64).copy()
    if name in ("plane", "cylinder"):
        s = np.sign(v[np.abs(v[:3]).argmax()])
        v[:4 if name == "plane" else 3] *= s
    if name == "cylinder":
        a = v[:3] / np.linalg.norm(v[:3])
        v[3:6] -= (v[3:6] @ a) * a
    return v


def test_packed_fits_match_jax_and_ignore_padding():
    segs = _segments(0)
    pts, nrm, w = _padded(segs)
    want = np.asarray(jprim.fit_all_types_packed(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(w)))
    got = tprim.fit_all_types_packed(torch.from_numpy(pts),
                                     torch.from_numpy(nrm),
                                     torch.from_numpy(w)).numpy()
    assert got.shape == (len(segs), 22) and np.isfinite(got).all()
    for i, (name, *_rest) in enumerate(segs):
        np.testing.assert_allclose(_canon(got[i], name),
                                   _canon(want[i], name), atol=2e-4)
    # 700 more rows of zero weight and zero points change no fit
    p2, n2, w2 = _padded(segs, extra=700)
    padded = tprim.fit_all_types_packed(torch.from_numpy(p2),
                                        torch.from_numpy(n2),
                                        torch.from_numpy(w2)).numpy()
    for i, (name, *_rest) in enumerate(segs):
        np.testing.assert_allclose(_canon(padded[i], name),
                                   _canon(got[i], name), atol=1e-5)


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_each_fit_matches_jax(name):
    _, p, n, w = [s for s in _segments(1, sizes=(400,)) if s[0] == name][0]
    pt, nt, wt = (torch.from_numpy(a) for a in (p, n, w))
    pj, nj, wj = (jnp.asarray(a) for a in (p, n, w))
    if name == "plane":
        got, want = tprim.fit_plane(pt, wt), jprim.fit_plane(pj, wj)
    elif name == "sphere":
        got, want = tprim.fit_sphere(pt, wt), jprim.fit_sphere(pj, wj)
    elif name == "cylinder":
        got = tprim.fit_cylinder(pt, nt, wt)
        want = jprim.fit_cylinder(pj, nj, wj)
    else:
        got, want = tprim.fit_cone(pt, nt, wt), jprim.fit_cone(pj, nj, wj)
    row_t, row_j = np.zeros(22, np.float32), np.zeros(22, np.float32)
    row_t[SLOTS[name]] = np.concatenate([np.ravel(g.numpy()) for g in got])
    row_j[SLOTS[name]] = np.concatenate([np.ravel(np.asarray(g))
                                         for g in want])
    np.testing.assert_allclose(_canon(row_t, name), _canon(row_j, name),
                               atol=2e-4)
    a = torch.from_numpy(np.random.RandomState(2).randn(60, 4)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(3).randn(60, 2)
                         .astype(np.float32))
    np.testing.assert_allclose(
        tprim.ridge_lstsq(a, y, 0.01).numpy(),
        np.asarray(jprim.ridge_lstsq(jnp.asarray(a.numpy()),
                                     jnp.asarray(y.numpy()), 0.01)),
        atol=1e-6)


def _params(rng):
    def unit():
        v = rng.randn(3)
        return (v / np.linalg.norm(v)).astype(np.float32)

    return {"plane": ("plane", unit(), np.float32(0.2)),
            "sphere": ("sphere", rng.randn(3).astype(np.float32) * 0.2,
                       np.float32(0.4)),
            "cylinder": ("cylinder", unit(),
                         rng.randn(3).astype(np.float32) * 0.2,
                         np.float32(0.3)),
            "cone": ("cone", rng.randn(3).astype(np.float32) * 0.2, unit(),
                     np.float32(0.5)),
            "torus": ("torus", rng.randn(3).astype(np.float32),
                      rng.randn(3).astype(np.float32) * 0.2,
                      np.float32(0.5), np.float32(0.1))}


DIST = {"plane": (jres.distance_from_plane, tres.distance_from_plane),
        "sphere": (jres.distance_from_sphere, tres.distance_from_sphere),
        "cylinder": (jres.distance_from_cylinder,
                     tres.distance_from_cylinder),
        "cone": (jres.distance_from_cone, tres.distance_from_cone),
        "torus": (jres.distance_from_torus, tres.distance_from_torus)}


@pytest.mark.parametrize("name", list(DIST))
def test_distances_match_jax(name):
    rng = np.random.RandomState(4)
    pts = rng.randn(500, 3).astype(np.float32) * 0.5
    w = rng.uniform(0, 1, 500).astype(np.float32)
    par = _params(rng)[name][1:]
    jfn, tfn = DIST[name]
    pt = torch.from_numpy(pts)
    for kw in (dict(sqrt=False), dict(sqrt=True), dict(reduce=False),
               dict(sqrt=True, reduce=False)):
        got = tfn(pt, *par, **kw).numpy()
        want = np.asarray(jfn(jnp.asarray(pts), *par, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    got = tfn(pt, *par, weights=torch.from_numpy(w)).numpy()
    want = np.asarray(jfn(jnp.asarray(pts), *par, weights=jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_residual_loss_batched_matches_residual_loss():
    """Every geometric type and splines of two surface sizes, on segments
    of different sizes: the batched padded calls against the port's
    per-segment `residual_loss` and against JAX's `residual_loss`, with
    and without sqrt."""
    rng = np.random.RandomState(5)
    params = _params(rng)
    points, parameters = {}, {}
    for i, (name, v) in enumerate(params.items()):
        points[i] = rng.randn(100 + 37 * i, 3).astype(np.float32) * 0.5
        parameters[i] = v
    for i, g in ((5, 100), (6, 130), (7, 100)):
        points[i] = rng.randn(200 + 11 * i, 3).astype(np.float32) * 0.5
        parameters[i] = ("open-spline" if i != 6 else "closed-spline",
                         rng.randn(g, 3).astype(np.float32) * 0.5)
    parameters[8] = None
    points[8] = rng.randn(10, 3).astype(np.float32)
    for sqrt in (False, True):
        got = tres.residual_loss_batched(points, parameters, sqrt=sqrt,
                                         device="cpu")
        per = tres.residual_loss({k: torch.from_numpy(v)
                                  for k, v in points.items()},
                                 parameters, sqrt=sqrt)
        want = jres.residual_loss({k: jnp.asarray(v)
                                   for k, v in points.items()},
                                  parameters, sqrt=sqrt)
        assert set(got) == set(per) == set(want) == set(range(8))
        for k in want:
            assert got[k][0] == per[k][0] == want[k][0]
            np.testing.assert_allclose(float(got[k][1]), float(per[k][1]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(got[k][1]),
                                       float(want[k][1]), rtol=1e-5)
        jb = jres.residual_loss_batched(points, parameters, sqrt=sqrt)
        for k in jb:
            np.testing.assert_allclose(float(got[k][1]), float(jb[k][1]),
                                       rtol=1e-5)
    for v in params.values():
        np.testing.assert_array_equal(tres.pack_geom_params(v),
                                      jres.pack_geom_params(v))


def _thin_cloud(seed, n=500):
    rng = np.random.RandomState(seed)
    p = rng.randn(n, 3) * np.array([1.0, 0.6, 0.02])
    p = p @ np.linalg.qr(rng.randn(3, 3))[0]
    return p.astype(np.float32), rng.uniform(0.5, 1.0, n).astype(np.float32)


def _smallest_sign_agrees(solver, cov):
    ref = np.asarray(jnp.linalg.eigh(jnp.asarray(cov))[1][:, 0])
    return float(np.sign(solver(cov) @ ref)) > 0


def test_standardize_points_takes_jax_eigh_sign():
    """On thin clouds where torch.linalg.eigh's smallest eigenvector has the
    other sign than JAX's, the port's rotation is JAX's. The cases are
    checked to include such clouds (7 of the first 40 seeds), and a
    resampled patch where numpy.linalg.eigh's sign differs too."""
    torch_flips, numpy_flips = [], []
    clouds = [_thin_cloud(s) for s in (3, 10, 14, 17, 0, 1)]
    # a cloud of unit weights (1 + 1e-8) whose covariance numpy's LAPACK
    # build gives the other sign
    cov_np = np.array([[54.273613, 1.7560425, -12.059607],
                       [1.7560425, 69.40349, 13.784767],
                       [-12.059607, 13.784767, 9.335184]], np.float32)
    numpy_flips.append(not _smallest_sign_agrees(
        lambda c: np.linalg.eigh(c)[1][:, 0], cov_np))
    assert _smallest_sign_agrees(
        lambda c: tbs.smallest_eigenvector(torch.from_numpy(c)).numpy(),
        cov_np)
    for p, w in clouds:
        got = [a.numpy() for a in tbs.standardize_points(
            torch.from_numpy(p), torch.from_numpy(w))]
        want = [np.asarray(a) for a in jbs.standardize_points(
            jnp.asarray(p), jnp.asarray(w))]
        np.testing.assert_allclose(got[3], want[3], atol=1e-5)
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], want[2], atol=1e-6)
        # torch's own eigh on the covariance JAX diagonalised
        n = p.shape[0]
        conf = w > 0.8
        thresh = np.sort(w)[n - n // 2]
        mask = conf if conf.sum() >= 400 else w >= thresh
        mean = (p * w[:, None] * mask[:, None]).sum(0) / (
            (w * mask).sum() + 1e-8)
        cm = (p - mean) * mask[:, None]
        cov = (cm.T @ cm).astype(np.float32)
        torch_flips.append(not _smallest_sign_agrees(
            lambda c: torch.linalg.eigh(torch.from_numpy(c))[1][:, 0].numpy(),
            cov))
    assert sum(torch_flips) >= 3 and any(numpy_flips), (torch_flips,
                                                        numpy_flips)


def test_standardize_points_masks_and_fallback():
    """The top-k fallback below 400 confident points and the +-inf masked
    extent, against JAX."""
    rng = np.random.RandomState(6)
    for n, conf in ((600, 100), (900, 450), (8000, 10)):
        p = (rng.randn(n, 3) * np.array([1.0, 0.4, 0.05])).astype(np.float32)
        w = rng.uniform(0.0, 0.7, n).astype(np.float32)
        w[rng.choice(n, conf, replace=False)] = 0.95
        p[w < 0.3] += 5.0  # outliers outside the mask move no extent
        got = [a.numpy() for a in tbs.standardize_points(
            torch.from_numpy(p), torch.from_numpy(w))]
        want = [np.asarray(a) for a in jbs.standardize_points(
            jnp.asarray(p), jnp.asarray(w))]
        for g, x in zip(got, want):
            np.testing.assert_allclose(g, x, rtol=1e-4, atol=1e-4)


def test_rotation_matches_jax_and_guards_degenerate_frame():
    rng = np.random.RandomState(7)
    b = np.array([1.0, 0.0, 0.0], np.float32)
    for _ in range(5):
        a = rng.randn(3).astype(np.float32)
        a /= np.linalg.norm(a)
        got = tbs._rotation_a_to_b(torch.from_numpy(a), torch.from_numpy(b))
        want = jbs._rotation_a_to_b_jax(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(got.numpy() @ a, b, atol=1e-5)
    for a in (b, -b):
        got = tbs._rotation_a_to_b(torch.from_numpy(a), torch.from_numpy(b))
        want = np.asarray(jbs._rotation_a_to_b_jax(jnp.asarray(a),
                                                   jnp.asarray(b)))
        np.testing.assert_array_equal(got.numpy(), np.eye(3, dtype=np.float32))
        np.testing.assert_array_equal(want, np.eye(3, dtype=np.float32))


def test_bspline_basis_sampling_and_kronecker_match_jax():
    for args in ((20, 20, 3, 3, 30), (10, 6, 3, 2, 17)):
        got = tbs.uniform_knot_bspline(*args)
        want = jbs.uniform_knot_bspline(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    nu, nv = tbs.uniform_knot_bspline(20, 20, 3, 3, 30)
    rng = np.random.RandomState(8)
    ctrl = rng.randn(2, 400, 3).astype(np.float32)
    got = tbs.sample_from_control_grid(torch.from_numpy(nu),
                                       torch.from_numpy(nv),
                                       torch.from_numpy(ctrl), 20, 20)
    want = jbs.sample_from_control_grid(jnp.asarray(nu), jnp.asarray(nv),
                                        jnp.asarray(ctrl), 20, 20)
    assert got.shape == (2, 900, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    nu2, nv2 = tbs.uniform_knot_bspline(6, 5, 3, 3, 12)
    surf = np.asarray(want)[0, :144]
    fit_t = tbs.fit_control_points_kronecker(
        torch.from_numpy(surf), torch.from_numpy(nu2), torch.from_numpy(nv2))
    fit_j = jbs.fit_control_points_kronecker(
        jnp.asarray(surf), jnp.asarray(nu2), jnp.asarray(nv2))
    np.testing.assert_allclose(fit_t.numpy(), np.asarray(fit_j), atol=1e-4,
                               rtol=1e-4)
    mean, std = rng.randn(3).astype(np.float32), rng.uniform(
        0.5, 2, 3).astype(np.float32)
    r = tbs._rotation_a_to_b(torch.tensor([0.0, 0.6, 0.8]),
                             torch.tensor([1.0, 0.0, 0.0]))
    got = tbs.reverse_transformation(torch.from_numpy(surf),
                                     torch.from_numpy(mean),
                                     torch.from_numpy(std), r)
    want = jbs.reverse_transformation(jnp.asarray(surf), jnp.asarray(mean),
                                      jnp.asarray(std), jnp.asarray(r.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_numpy_copies_equal_jax_package():
    rng = np.random.RandomState(9)
    # a tuple: the samplers normalise an array axis in place
    ax = tuple(rng.randn(3))
    pts = rng.randn(200, 3)
    pairs = [
        (jsmp.sample_plane(0.3, ax, pts[0], 20, 20),
         tsmp.sample_plane(0.3, ax, pts[0], 20, 20)),
        (jsmp.sample_sphere(0.4, pts[1], 100),
         tsmp.sample_sphere(0.4, pts[1], 100)),
        (jsmp.sample_cylinder(0.3, pts[2], ax), tsmp.sample_cylinder(
            0.3, pts[2], ax)),
        (jsmp.sample_cylinder_trim(0.3, pts[2], ax, pts),
         tsmp.sample_cylinder_trim(0.3, pts[2], ax, pts)),
        (jsmp.sample_cone(pts[3], ax, 0.4), tsmp.sample_cone(pts[3], ax, 0.4)),
        (jsmp.sample_cone_trim(pts[3], ax, 0.4, pts),
         tsmp.sample_cone_trim(pts[3], ax, 0.4, pts)),
        (jsmp.sample_torus(0.5, 0.1, pts[4], ax),
         tsmp.sample_torus(0.5, 0.1, pts[4], ax)),
        (jsurf.regular_parameterization(7, 5),
         tsurf.regular_parameterization(7, 5)),
        (jsurf.boundary_parameterization(6),
         tsurf.boundary_parameterization(6)),
        (jsurf.bezier_surface(pts[:16].reshape(4, 4, 3), 9, 7),
         tsurf.bezier_surface(pts[:16].reshape(4, 4, 3), 9, 7)),
    ]
    grid = jsmp.sample_plane(0.3, ax, pts[0], 12, 10)
    pairs.append((jsurf.grid_bit_mask(pts, grid, 12, 10, 0.3),
                  tsurf.grid_bit_mask(pts, grid, 12, 10, 0.3)))
    jv, jt = jsurf.trimmed_surface_mesh(pts, grid, 12, 10, "cone")
    tv, tt = tsurf.trimmed_surface_mesh(pts, grid, 12, 10, "cone")
    pairs += [(jv, tv), (np.asarray(jt), np.asarray(tt))]
    pairs += [(jarap.grid_triangles(5, 4), tarap.grid_triangles(5, 4)),
              (jarap.boundary_indices(5, 4), tarap.boundary_indices(5, 4))]
    u, v = np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 7))
    sheet = np.stack([u, v, 0.2 * u * v], -1).reshape(-1, 3)
    cloud = sheet[rng.choice(56, 40, replace=False)] + rng.randn(40, 3) * 0.01
    pairs.append((jarap.arap_deform(sheet, cloud, 7, 8, iters=5),
                  tarap.arap_deform(sheet, cloud, 7, 8, iters=5)))
    pairs.append((jarap.match_targets(sheet, cloud,
                                      np.random.RandomState(1)),
                  tarap.match_targets(sheet, cloud,
                                      np.random.RandomState(1))))
    for want, got in pairs:
        np.testing.assert_array_equal(got, want)
