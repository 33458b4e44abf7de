"""The port's tools on the CPU against the JAX package's: the colour dumps
(`gen_vis`, `utils.vis`), the grid renderer, the sklearn baselines, the
native preprocessing library, the per-sample metrics and the datasets'
native route."""
import os

import numpy as np
import pytest

from sednet_tpu import gen_vis as jgen_vis
from sednet_tpu.cluster import baselines as jbaselines
from sednet_tpu.data import native as jnative
from sednet_tpu.data.datasets import _H5Dataset as JDataset
from sednet_tpu.metrics import segmentation as jseg
from sednet_tpu.utils import vis as jvis
from sednet_tpu_torch import gen_vis
from sednet_tpu_torch.cluster import baselines
from sednet_tpu_torch.data import native
from sednet_tpu_torch.data.datasets import _H5Dataset
from sednet_tpu_torch.metrics import segmentation as seg
from sednet_tpu_torch.utils import grid_vis, vis


def test_palettes_are_jax_bytes():
    assert vis.COLORS_TYPE.tobytes() == jvis.COLORS_TYPE.tobytes()
    for n in (1, 2, 7, 50):
        assert (vis.instance_palette(n).tobytes()
                == jvis.instance_palette(n).tobytes())


def test_save_xyz_is_jax_bytes(rng, tmp_path):
    pts = rng.randn(40, 3)
    vis.save_xyz(str(tmp_path / "a.xyz"), pts)
    jvis.save_xyz(str(tmp_path / "b.xyz"), pts)
    assert (tmp_path / "a.xyz").read_bytes() == (tmp_path / "b.xyz").read_bytes()


def _dumps(rng, src, ids, n=300, gt=True):
    os.makedirs(src, exist_ok=True)
    for sid in ids:
        pts = rng.uniform(-1, 1, (n, 6))
        np.savetxt(os.path.join(src, f"{sid}_GT_points.txt"), pts,
                   fmt="%0.6f", delimiter=";")
        np.savetxt(os.path.join(src, f"{sid}_type.txt"),
                   rng.randint(0, 6, n), fmt="%d")
        np.savetxt(os.path.join(src, f"{sid}_inst.txt"),
                   rng.randint(0, 12, n), fmt="%d")
        if gt:
            np.savetxt(os.path.join(src, f"{sid}_GT_type.txt"),
                       rng.randint(0, 6, n), fmt="%d")
            np.savetxt(os.path.join(src, f"{sid}_GT_inst.txt"),
                       rng.randint(0, 9, n), fmt="%d")


# the JAX tool writes through its native library's float32 writer (the
# committed native/libsednet_preprocess.so), the port through np.savetxt of
# the float32 rows: the same bytes, file for file
def test_gen_total_vis_is_jax_bytes(rng, tmp_path):
    assert jnative.available()
    src_t, src_j = str(tmp_path / "t"), str(tmp_path / "j")
    _dumps(np.random.RandomState(0), src_j, ["0", "1"])
    _dumps(np.random.RandomState(0), src_t, ["0", "1"])
    dst_t = gen_vis.gen_total_vis(src_t, workers=2)
    dst_j = jgen_vis.gen_total_vis(src_j, workers=2)
    names = sorted(os.listdir(dst_j))
    assert names == sorted(os.listdir(dst_t)) and len(names) == 8
    for name in names:
        with open(os.path.join(dst_t, name), "rb") as a, \
                open(os.path.join(dst_j, name), "rb") as b:
            assert a.read() == b.read(), name


def test_gen_vis_cli_without_gt(rng, tmp_path):
    src = str(tmp_path / "d")
    _dumps(rng, src, ["3"], gt=False)
    gen_vis.main([src, "--ids", "3", "--workers", "1"])
    assert sorted(os.listdir(os.path.join(src, "VIS"))) == [
        "3_pred_inst.txt", "3_pred_type.txt"]
    rows = np.loadtxt(os.path.join(src, "VIS", "3_pred_type.txt"),
                      delimiter=";")
    assert rows.shape == (300, 6)


# the grid renderer: the same image as JAX's, pixel for pixel (same code,
# same matplotlib), and a PNG of that shape on disk
def test_grid_vis_matches_jax(rng, tmp_path):
    from sednet_tpu.utils import grid_vis as jgrid

    clouds = [rng.uniform(-1, 1, (200, 6)) * [1, 1, 1, 100, 100, 100]
              for _ in range(3)]
    path = str(tmp_path / "g.png")
    img = grid_vis.render_pointclouds_grid(clouds, path, width_px=256)
    want = jgrid.render_pointclouds_grid(clouds, None, width_px=256)
    assert img.dtype == np.uint8 and img.shape == want.shape
    assert img.shape[1] == 256 and img.shape[2] == 3
    np.testing.assert_array_equal(img, want)
    assert os.path.getsize(path) > 0
    mesh = grid_vis.vis_batch_in_grid(rng.uniform(-1, 1, (2, 64, 3)),
                                      tessellate=True, width_px=128)
    assert mesh.shape[1] == 128


def test_baselines_kmeans_matches_jax(rng):
    x = np.concatenate([rng.randn(60, 4) + 5 * i for i in range(3)])
    np.testing.assert_array_equal(baselines.cluster(x, 3),
                                  jbaselines.cluster(x, 3))


def test_native_savetxt_is_numpy_bytes(rng, tmp_path):
    if not native.available():
        pytest.skip("no g++ to build native/preprocess.cpp")
    a = (rng.randn(300, 6) * 10).astype(np.float32)
    ints = rng.randint(-5, 5000, (100, 3))
    for arr, fmt, delim in ((a, "%0.4f", ";"), (a, "%.6f", " "),
                            (ints, "%d", " "), (a[:, 0], "%0.3f", " ")):
        native.savetxt_fast(str(tmp_path / "n.txt"), arr, fmt=fmt,
                            delimiter=delim)
        np.savetxt(str(tmp_path / "p.txt"), arr, fmt=fmt, delimiter=delim)
        assert ((tmp_path / "n.txt").read_bytes()
                == (tmp_path / "p.txt").read_bytes()), fmt
    with pytest.raises(ValueError, match="format"):
        native.savetxt_fast(str(tmp_path / "x.txt"), a, fmt="%e")
    # built beside the package under build/, never into native/
    assert native.build().parents[1] == native.BUILD_ROOT
    assert sorted(os.listdir(native.SOURCE.parent)) == [
        "Makefile", "libsednet_preprocess.so", "preprocess.cpp"]


# the fused C++ preprocessing: the port's build of native/preprocess.cpp
# against the JAX package's library, item for item (augment on, the same
# seeds: the same arrays), and the datasets' native route against JAX's
def test_native_preprocess_matches_jax(rng):
    if not native.available():
        pytest.skip("no g++ to build native/preprocess.cpp")
    pts = rng.randn(3, 500, 3).astype(np.float32)
    nrm = rng.randn(3, 500, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    got = native.preprocess_batch(pts.copy(), nrm.copy(), augment=True,
                                  seed=5, threads=2)
    want = jnative.preprocess_batch(pts.copy(), nrm.copy(), augment=True,
                                    seed=5, threads=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    labels = rng.randint(0, 8, (3, 500))
    prim = rng.randint(0, 6, (3, 500))
    kw = dict(train=True, num_points=400, seed=3, use_native=True)
    port, jax_ds = (_H5Dataset(pts, labels, nrm, prim, **kw),
                    JDataset(pts, labels, nrm, prim, **kw))
    assert port.use_native and jax_ds.use_native
    for i in range(3):
        a, b = port[i], jax_ds[i]
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=1e-6,
                                       err_msg=key)


def test_mean_iou_one_sample_matches_jax(rng):
    for c in (2, 6):
        pred, gt = rng.randint(0, c, 200), rng.randint(0, c, 200)
        assert (seg.mean_iou_one_sample(pred, gt, c)
                == jseg.mean_iou_one_sample(pred, gt, c))


# the type accuracy after the relaxed-IoU match: equal floats, on scores and
# on ids, with -1 unlabelled points and the ABC remaps (6, 7, 9 -> 0, 8 -> 2)
@pytest.mark.parametrize("noise", [False, True])
def test_compute_type_miou_abc_matches_jax(rng, noise):
    n = 300
    i_gt = rng.randint(0, 7, n)
    if noise:
        i_gt[::11] = -1
    cluster_pred = np.where(rng.rand(n) < 0.8, i_gt.clip(0), rng.randint(0, 9, n))
    t_gt = rng.randint(0, 10, n)
    scores = rng.rand(n, 10).astype(np.float32)
    for tp in (scores, scores.argmax(-1)):
        assert (seg.compute_type_miou_abc(tp, t_gt, cluster_pred, i_gt)
                == jseg.compute_type_miou_abc(tp, t_gt, cluster_pred, i_gt))


# where matplotlib or sklearn is absent (the card's machine), the call
# raises ImportError naming it; without g++ the native route raises, in the
# library and in a dataset that asks for it (JAX silently takes numpy)
def test_missing_dependencies_raise(rng, monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        grid_vis.render_pointclouds_grid([rng.randn(10, 3)])
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="sklearn"):
        baselines.cluster(rng.randn(10, 3), 2)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "none")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.savetxt_fast(str(tmp_path / "x.txt"), np.zeros((2, 2)))
    pts = rng.randn(1, 50, 3).astype(np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _H5Dataset(pts, np.zeros((1, 50), int), pts, np.zeros((1, 50), int),
                   use_native=True)
