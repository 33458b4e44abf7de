"""The frozen arithmetic against shapes worked out by hand."""
import pytest

from portbench import counts


def test_peaks():
    assert counts.PEAK["tf32"] == 495e12 and counts.PEAK["bf16"] == 989e12
    assert counts.PEAK["fp32"] == 67e12 and counts.PEAK["hbm"] == 3.35e12
    assert counts.PEAK["fp32_split"] == pytest.approx(165e12)


def test_products_and_rooflines():
    assert counts.mm(2, 3, 4) == 48
    assert counts.knn_flops(10000, 64) == 1.28e10
    assert counts.knn_bytes(10000, 64, 64) == 10000 * 64 * 4 + 10000 * 64 * 8
    assert counts.roofline_s(1.65e11, 0, "fp32_split") == pytest.approx(1e-3)
    assert counts.roofline_s(1.0, 3.35e9, "bf16") == pytest.approx(1e-3)
    assert counts.knn_launch_peak(6) == "fp32"
    assert counts.knn_launch_peak(64) == "fp32_split"


def test_one_point_forward_by_hand():
    f = counts.sednet_forward_flops(1, 1)
    # graphs: 2*6 (xyz and normals) + 2 * 2*64
    assert f["knn"] == 12 + 256
    heads = (1280 * 512 + 512 * 256 + 256 * 256 + 256 * 6 + 256 * 128
             + 128 * 2 + 256 * 256 + 256 * 256 + 8 * 256 + 256 * 128)
    assert f["layers"] == 2 * (12 * 64 + 128 * 64 + 128 * 128 + 256 * 1024
                               + heads)
    assert counts.sednet_forward_flops(1, 1, first_graph=False)["knn"] == 256
    assert counts.train_step_flops(1, 1, 1) == 3 * f["layers"] + f["knn"]


def test_kernel_bounds_of_the_port_kernel_table():
    # PERF.md's kernel table: K2b (8, 10000, 140) 2.715 ms on the TF32
    # split, 0.453 ms in bf16; K1 layer 2 (8, 10000, 64) 0.621 ms
    step = [w for w in counts.cluster_work(10000, 140, 1, 10000, False)
            if w[0] == "shift_step"][0]
    assert 8 * counts.roofline_s(*step[1:]) * 1e3 == pytest.approx(2.715, abs=1e-3)
    step = [w for w in counts.cluster_work(10000, 140, 1, 10000, True)
            if w[0] == "shift_step"][0]
    assert 8 * counts.roofline_s(*step[1:]) * 1e3 == pytest.approx(0.453, abs=1e-3)
    k1 = 8 * counts.roofline_s(counts.knn_flops(10000, 64),
                               counts.knn_bytes(10000, 64, 64), "fp32_split")
    assert k1 * 1e3 == pytest.approx(0.621, abs=1e-3)


def test_cluster_work_counts_steps_and_nms():
    work = counts.cluster_work(100, 8, 5, 50, False)
    assert [w[0] for w in work].count("shift_step") == 5
    assert [w[0] for w in work].count("nms") == 3
    assert work[0] == ("bandwidth", counts.mm(50, 8, 50), 50 * 8 * 4 + 50 * 4,
                       "fp32_split")
    assert counts.bandwidth_k(0.015, 10000) == 150
    assert counts.bandwidth_k(0.015, 50) == 1


def test_eval_batch_flops_composition():
    n, k, w, s = 200, 8, 20, 3
    t = counts.sednet_forward_flops(n, k)
    i = counts.sednet_forward_flops(n, k, first_graph=False)
    cl = sum(f for _, f, _, _ in counts.cluster_work(n, w, s, n, False))
    per = t["knn"] + t["layers"] + i["knn"] + i["layers"] + counts.knn_flops(n, 3) + cl
    assert counts.eval_batch_flops(2, n, k, w, s, n) == 2 * per
