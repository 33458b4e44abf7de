"""The port's post-processing (sednet_tpu_torch.postproc, numpy copies of
sednet_tpu.postproc) against the JAX package's on the fixtures of the JAX
package's own tests (tests/test_postproc.py, tests/test_arg2mesh.py): the
fits, boundary masks, intersections, `process_shape` and `arg2mesh` give
equal values and byte-equal output files."""
import os

import numpy as np
import pytest

import sednet_tpu.postproc as pp_jax
import sednet_tpu.postproc.arg2mesh as mesh_jax
import sednet_tpu_torch.postproc as pp_port
import sednet_tpu_torch.postproc.arg2mesh as mesh_port


def assert_same(a, b):
    """Equality of nested tuples, lists, dicts, arrays and scalars: exact
    for integers, booleans and strings, to 1e-12 for floating arrays.
    numpy's BLAS may sum a product in another order from one call to the
    next (the JAX package's own cone_mesh differs from itself by 2.2e-16
    between two calls on the same input)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


def _circle(rng):
    t = rng.rand(100) * 2 * np.pi
    return 1.5 + 0.7 * np.cos(t), -0.3 + 0.7 * np.sin(t)


def _circle_3d(rng):
    t = rng.rand(200) * 2 * np.pi
    axis = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    x_axis = np.array([0.0, 0.0, 1.0])
    y_axis = np.cross(axis, x_axis)
    return ((0.4 * (np.cos(t)[:, None] * x_axis + np.sin(t)[:, None] * y_axis)
             + np.array([0.1, 0.2, 0.3])),)


def _contaminated_plane(rng):
    pts = np.concatenate([
        np.c_[rng.rand(300) - 0.5, rng.rand(300) - 0.5, 0.2 * np.ones(300)],
        rng.randn(40, 3) * 0.1 + 3.0])
    return pts, np.tile([0.0, 0.0, 1.0], (340, 1))


def _cylinder(rng):
    t = rng.rand(800) * 2 * np.pi
    z = rng.rand(800) - 0.5
    return (np.c_[0.3 * np.cos(t), 0.3 * np.sin(t), z],
            np.c_[np.cos(t), np.sin(t), np.zeros(800)])


def _cone(rng):
    t = np.sqrt(rng.rand(600)) * 0.8 + 0.05
    phi = rng.rand(600) * 2 * np.pi
    r = t * np.tan(0.4)
    return (np.c_[r * np.cos(phi), r * np.sin(phi), t],
            np.c_[np.cos(0.4) * np.cos(phi), np.cos(0.4) * np.sin(phi),
                  -np.sin(0.4) * np.ones(600)])


def _sphere(rng):
    d = rng.randn(500, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return 0.1 + 0.6 * d, d


def _weighted_plane(rng):
    pts = rng.randn(200, 3)
    pts[:, 2] = 0.0
    return pts, np.tile([0.0, 0.0, 1.0], (200, 1)), rng.rand(200)


def _slabs(rng):
    a = np.c_[rng.rand(200), rng.rand(200), np.zeros(200)]
    b = np.c_[rng.rand(200) + 0.98, rng.rand(200), np.zeros(200)]
    return (np.concatenate([a, b]),
            np.r_[np.zeros(200, np.int32), np.ones(200, np.int32)])


def _three_slabs(rng):
    a = np.c_[rng.rand(300), rng.rand(300), np.zeros(300)]
    b = np.c_[rng.rand(300) + 0.99, rng.rand(300), np.zeros(300)]
    c = np.c_[rng.rand(300) + 10, rng.rand(300), np.zeros(300)]
    return (np.concatenate([a, b, c]),
            np.r_[np.zeros(300, np.int32), np.ones(300, np.int32),
                  np.full(300, 2, np.int32)], np.array([0, 1, 2]))


def _box(rng, n=800):
    """tests/test_postproc.py _box_shape: a floor and three walls."""
    m = n // 4
    floor = np.c_[rng.rand(m), rng.rand(m), np.zeros(m)]
    wall_a = np.c_[np.zeros(m), rng.rand(m), rng.rand(m)]
    wall_b = np.c_[rng.rand(m), np.zeros(m), rng.rand(m)]
    wall_c = np.c_[np.ones(m), rng.rand(m), rng.rand(m)]
    pts = np.concatenate([floor, wall_a, wall_b, wall_c])
    nrm = np.concatenate([np.tile([0.0, 0, 1], (m, 1)),
                          np.tile([1.0, 0, 0], (m, 1)),
                          np.tile([0.0, 1, 0], (m, 1)),
                          np.tile([1.0, 0, 0], (m, 1))])
    insts = np.repeat(np.arange(4, dtype=np.int32), m)
    return pts, nrm, insts, np.ones(4 * m, np.int32)


def _bad_points(rng):
    pts, nrm, insts, _ = _box(rng, 400)
    pts = pts + 0.02 * rng.randn(*pts.shape)
    params = {0: ("plane", np.array([0.0, 0, 1]), 0.0),
              1: ("plane", np.array([1.0, 0, 0]), 0.0),
              2: ("cylinder", np.array([0.0, 0, 1]), np.zeros(3), 0.5),
              3: None}
    return pts, insts, np.arange(4), params


CYL = ("cylinder", np.array([0.0, 0, 1]), np.zeros(3), 0.5)
CONE = ("cone", np.zeros(3), np.array([0.0, 0, 1]), 0.4)
SPHERE = ("sphere", np.zeros(3), 1.0)
_N = np.array([0.0, 1.0, 1.0]) / np.sqrt(2)

# (case id, function path under postproc, fixture (rng -> args), kwargs)
CASES = [
    ("fit_circle_2d", "robust_fits.fit_circle_2d", _circle, {}),
    ("circle_segmentation", "robust_fits.circle_segmentation", _circle_3d,
     {}),
    ("fit_plane", "RobustFitter.fit_plane", _contaminated_plane, {}),
    ("fit_plane_weights", "RobustFitter.fit_plane", _weighted_plane, {}),
    ("fit_cylinder", "RobustFitter.fit_cylinder", _cylinder, {}),
    ("fit_cone", "RobustFitter.fit_cone", _cone, {}),
    ("fit_sphere", "RobustFitter.fit_sphere", _sphere, {}),
    ("three_nn", "boundary.three_nn_indices", lambda r: (_slabs(r)[0],), {}),
    ("boundary_loose", "boundary.boundary_edge_mask", _slabs,
     {"strict": False}),
    ("boundary_strict", "boundary.boundary_edge_mask", _slabs, {}),
    ("bad_points", "boundary.bad_points_mask", _bad_points, {}),
    ("face_adjacency", "boundary.face_adjacency", _three_slabs,
     {"nn_num_thresh": 2}),
    ("plane_plane", "intersections.plane_plane",
     lambda r: (("plane", np.array([0.0, 0, 1]), 0.0),
                ("plane", np.array([0.0, 1, 0]), 0.5)), {}),
    ("plane_plane_parallel", "intersections.plane_plane",
     lambda r: (("plane", np.array([0.0, 0, 1]), 0.0),
                ("plane", np.array([0.0, 0, 1]), 1.0)), {}),
    ("plane_cylinder_circle", "intersections.plane_cylinder",
     lambda r: (("plane", np.array([0.0, 0, 1]), 0.2), CYL), {}),
    ("plane_cylinder_lines", "intersections.plane_cylinder",
     lambda r: (("plane", np.array([1.0, 0, 0]), 0.2), CYL), {}),
    ("plane_cylinder_miss", "intersections.plane_cylinder",
     lambda r: (("plane", np.array([1.0, 0, 0]), 2.0), CYL), {}),
    ("plane_cylinder_ellipse", "intersections.plane_cylinder",
     lambda r: (("plane", _N, 0.0), CYL), {}),
    ("plane_cone", "intersections.plane_cone",
     lambda r: (("plane", np.array([0.0, 0, 1]), 0.5), CONE), {}),
    ("plane_sphere", "intersections.plane_sphere",
     lambda r: (("plane", np.array([0.0, 0, 1]), 0.6), SPHERE), {}),
    ("cylinder_cone", "intersections.cylinder_cone",
     lambda r: (("cylinder", np.array([0.0, 0, 1]), np.zeros(3), 0.5),
                ("cone", np.array([0.0, 0, 1]), np.array([0.0, 0, 1]),
                 np.pi / 4)), {}),
    ("cylinder_sphere", "intersections.cylinder_sphere",
     lambda r: (CYL, SPHERE), {}),
    ("intersect_cone_plane", "intersections.intersect",
     lambda r: (CONE, ("plane", np.array([0.0, 0, 1]), 0.5)), {}),
    ("line_line", "intersections.line_line_intersection",
     lambda r: ([1, 0, 0], [0, 0, 0], [0, 1, 0], [0.3, 0, 0]), {}),
    ("line_circle", "intersections.line_circle_intersection",
     lambda r: (([1.0, 0, 0], [0.0, 0, 0]),
                (np.zeros(3), np.array([1.0, 0, 0]), np.array([0.0, 1, 0]),
                 0.5)), {}),
    ("majority_type", "pipeline.majority_type_with_priors",
     lambda r: (np.array([0] * 60 + [2] * 30 + [1] * 10),), {}),
    ("cone_mesh", "arg2mesh.cone_mesh",
     lambda r: (("cone", np.array([0.0, 0, 1]), np.array([0.0, 0, 1]),
                 np.pi / 6),
                {0: ("circle", np.zeros(3), np.array([1.0, 0, 0]),
                     np.array([0.0, 1, 0]), np.tan(np.pi / 6))}), {}),
]


def _resolve(pkg, path):
    import importlib

    mod, name = path.split(".")
    if mod == "RobustFitter":
        return getattr(pkg.RobustFitter(), name)
    return getattr(importlib.import_module(f"{pkg.__name__}.{mod}"), name)


@pytest.mark.parametrize("path,fixture,kw",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_postproc_function_matches_jax(path, fixture, kw):
    args = fixture(np.random.RandomState(0))
    want = _resolve(pp_jax, path)(*args, **kw)
    got = _resolve(pp_port, path)(*args, **kw)
    assert_same(got, want)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _spline_box(rng):
    pts, nrm, insts, types = _box(rng, 400)
    types[insts == 3] = 0  # one closed-spline instance

    def fake_spline_fitter(p, n, closed):
        return ("closed-spline" if closed else "open-spline",
                p[:50].astype(np.float32))

    return (pts, nrm, insts, types), {
        "min_points": 30, "corner_dist_thresh": 0.2,
        "spline_fitter": fake_spline_fitter}


def _corner_box(rng):
    return _box(rng, 800), {"min_points": 30, "corner_dist_thresh": 0.2,
                            "filter_bad_points": True}


def _synthetic(rng):
    from sednet_tpu_torch.data import make_synthetic_shape

    d = make_synthetic_shape(rng, n_points=1200, n_segments=4)
    from sednet_tpu_torch.data import project_types_fitting

    return (d["points"].astype(np.float64), d["normals"].astype(np.float64),
            d["labels"].astype(np.int64),
            project_types_fitting(d["prim"].astype(np.int64))), {}


# process_shape, save_shape_parameters and arg2mesh, end to end as
# predict.run_postproc chains them: every file both packages write
# (param and inter-line dumps, edges, corners, spline surfaces, OBJ meshes)
# is byte-equal.
@pytest.mark.parametrize("fixture", [_spline_box, _corner_box, _synthetic],
                         ids=["spline_box", "corner_box", "synthetic"])
def test_process_shape_and_arg2mesh_write_jax_files(fixture, tmp_path):
    args, kw = fixture(np.random.RandomState(0))
    trees = {}
    for name, pkg, mesh in (("jax", pp_jax, mesh_jax),
                            ("port", pp_port, mesh_port)):
        out = str(tmp_path / name)
        res = pkg.process_shape(*args, **kw)
        pkg.save_shape_parameters(out, "7", res)
        mesh.arg2mesh(os.path.join(out, "7_mesh"),
                      os.path.join(out, "paras", "param_7.txt"),
                      os.path.join(out, "paras", "param_inter_lines_7.json"))
        trees[name] = _files(out)
    assert trees["port"].keys() == trees["jax"].keys()
    assert "paras/param_7.txt" in trees["port"]
    for path, data in trees["jax"].items():
        assert trees["port"][path] == data, path


def _merged_shape(rng):
    """A cloud whose instance 0 holds the two faces of a slab (over-merged,
    80% of the points; opposite normals), with a small instance 1 and types
    1 (plane) and 2."""
    n = 600
    pts, nrm = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
    part = np.repeat(np.arange(3), [240, 240, 120])
    for p in range(2):
        rows = part == p
        pts[rows] = rng.uniform(0, 0.3, (rows.sum(), 3))
        pts[rows, 2] = 0.1 * p
        nrm[rows, 2] = 1.0 - 2.0 * p
    small = part == 2
    pts[small] = rng.uniform(2, 3, (small.sum(), 3))
    nrm[small] = rng.randn(small.sum(), 3)
    nrm[small] /= np.linalg.norm(nrm[small], axis=1, keepdims=True)
    insts = np.where(part == 2, 1, 0).astype(np.int64)
    types = np.where(part == 2, 2, 1).astype(np.int64)
    return pts, nrm, insts, types


# resplit_instances on JAX's subsamples (the permutation of fold_in(key, k)
# for the k-th instance id): the same labels, the merged instance split in
# two, one keeping its id, the small one left alone; a ratio above the merged
# instance's share leaves every label as it was.
def test_resplit_instances_matches_jax(rng):
    import jax
    import torch

    from sednet_tpu.postproc.inst_cluster import resplit_instances as jax_rs
    from sednet_tpu_torch.postproc.inst_cluster import subsample_size

    pts, nrm, insts, types = _merged_shape(rng)
    key = jax.random.PRNGKey(3)
    sels = {}
    for k, pid in enumerate(np.unique(insts)):
        rows = int((insts == pid).sum())
        m = min(subsample_size(rows), rows)
        sels[int(pid)] = torch.from_numpy(np.array(jax.random.permutation(
            jax.random.fold_in(key, k), rows)[:m]))
    want = jax_rs(pts, nrm, insts, types, key=key)
    got = pp_port.resplit_instances(pts, nrm, insts, types, device="cpu",
                                    sels=sels)
    np.testing.assert_array_equal(got, want)
    assert sorted(np.unique(got[insts == 0])) == [0, 2]
    assert (got[insts == 1] == 1).all()
    same = pp_port.resplit_instances(pts, nrm, insts, types, device="cpu",
                                     ratio_thresh=0.9, sels=sels)
    np.testing.assert_array_equal(same, insts)
