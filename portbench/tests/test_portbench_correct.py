"""The `correct` check, driven through a whole run on the CPU at a size a
test can hold: the sound program passes the cell's limits, and the
control (the reference at the precision below the configuration's) and
each fault the cell can have, planted in the timed path, do not."""
import time

import pytest
import torch

from portbench import faults, run

SMALL = {"eval": ({"points": 512, "batch": 2, "pool": 4, "warm": 1},
                  {"knn": 16}),
         "train": ({"points": 512, "batch": 2, "pool": 6},
                   {"knn": 16, "edge_topk": 100})}


# the large-cloud cell at a small size still takes the matrix-free solve
# and a bandwidth subsample smaller than the cloud
LARGE = {"spectral_dense_max_n": 256, "ms_num_samples": 400}


def drive(cell, **kw):
    _, _, config, traffic, limits = run.load_cell(cell)
    t, c = SMALL[traffic["kind"]]
    if traffic["points"] > config["config"]["spectral_dense_max_n"]:
        c = {**c, **LARGE}
    config = {**config, "config": {**config["config"], **c}}
    res = run.kind_module(traffic["kind"]).run(
        config, {**traffic, **t}, seed=2 ** 31 + 99, seconds=0.5,
        trace=False, device="cpu", t_start=time.time(), **kw)
    return run.judge(res["checks"], limits)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["sednet_normal.eval_10k",
                                  "sednet_normal_bf16.eval_10k",
                                  "sednet_normal.eval_32k",
                                  "sednet_normal.train_b4"])
def test_sound_program_is_correct(cell):
    ok, checks = drive(cell)
    assert ok, checks


@pytest.mark.parametrize("cell,prec", [("sednet_normal.eval_10k", "tf32"),
                                       ("sednet_normal_bf16.eval_10k", "fp8"),
                                       ("sednet_normal.eval_32k", "tf32"),
                                       ("sednet_normal.train_b4", "tf32")])
def test_control_is_not_correct(cell, prec):
    ok, checks = drive(cell, control=prec)
    assert not ok, checks


@pytest.mark.parametrize("cell,fault", [
    ("sednet_normal.eval_10k", "unshifted_half"),
    ("sednet_normal.eval_10k", "unshifted_cloud"),
    ("sednet_normal.eval_10k", "unshifted_tail"),
    ("sednet_normal_bf16.eval_10k", "unshifted_half"),
    ("sednet_normal_bf16.eval_10k", "unshifted_cloud"),
    ("sednet_normal.eval_32k", "unshifted_half")])
def test_shift_faults_are_not_correct(cell, fault):
    """A shift that leaves out half the batch, one cloud or (where the
    cell holds a cloud's 99th percentile) a tail tile of rows, with NMS
    and the metrics run on what it left."""
    ok, checks = drive(cell, cluster_hook=faults.CLUSTER[fault])
    assert not ok, checks


def test_altered_answer_is_not_correct():
    ok, checks = drive("sednet_normal.eval_10k",
                       capture_hook=faults.altered_labels)
    assert not ok, checks


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch])
def test_train_faults_are_not_correct(fault):
    ok, checks = drive("sednet_normal.train_b4", step_hook=fault)
    assert not ok, checks


def test_unchanged_state_reads_one():
    _, checks = drive("sednet_normal.train_b4", step_hook=faults.unchanged)
    assert checks["change_gap"]["value"] == pytest.approx(1.0)
