"""The CUDA kernels of sednet_tpu_torch against their plain PyTorch
versions, on the card. Without an NVIDIA GPU every test here skips: a CUDA
kernel has no CPU mode. This file imports no JAX, so that it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py -q
"""
import numpy as np
import pytest
import torch

from sednet_tpu_torch.ops import cuda_kernels as ck
from sednet_tpu_torch.ops.flash_topk import compare_with_plain, flash_topk


def _points_normals(rng, n):
    x = rng.randn(n, 6).astype(np.float32)
    x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    return x


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _tie_heavy(rng, r, c, e=16, vocab=7):
    voc = _unit(rng, vocab, e)
    return voc[rng.randint(0, vocab, r)], voc[rng.randint(0, vocab, c)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric,d,k,largest", [
    ("sqdist", 64, 64, False), ("points_normals", 6, 64, False),
    ("sqdist", 128, 128, False), ("sqdist", 16, 16, True)])
def test_flash_topk_kernel_matches_plain(cuda, metric, d, k, largest):
    rng = np.random.RandomState(1)
    x = np.stack([_points_normals(rng, 2000) for _ in range(2)]) \
        if metric == "points_normals" else \
        (rng.randn(2, 2000, d) / np.sqrt(d)).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    before = flash_topk.launches
    idx, dist = flash_topk(t, t, k, metric=metric, largest=largest,
                           return_distances=True)
    torch.cuda.synchronize()
    assert flash_topk.launches == before + 1
    # tolerances and the near-tie rule: see compare_with_plain
    cmp = compare_with_plain(t, t, k, idx, dist, metric=metric,
                             largest=largest)
    assert cmp["bad_rows"] == 0 and cmp["max_abs_err"] <= cmp["tol"], cmp
    assert cmp["nbr_err"] <= cmp["tol"], cmp
    assert cmp["swapped_rows"] <= 0.01 * cmp["rows"], cmp


@pytest.mark.cuda
def test_mean_shift_kernel_matches_plain(cuda):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(_unit(rng, 2, 3000, 128)).to(cuda)
    bw = torch.tensor([0.15, 0.3], device=cuda)
    got = ck.mean_shift_step_batched(x, x, bw)
    want = ck.mean_shift_step_plain(x, x, 1.0 / (bw * bw))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    one = ck.mean_shift_step(x[0], x[0], bw[0])
    torch.testing.assert_close(one, want[0], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_colmax_kernel_matches_plain_on_ties(cuda):
    rng = np.random.RandomState(3)
    rows, cols = _tie_heavy(rng, 3000, 3000, e=128, vocab=40)
    r, c = torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)
    bias = torch.from_numpy(rng.randint(0, 5, 3000).astype(np.float32)).to(cuda)
    for thresh, gain in ((float("inf"), 1.0), (0.5, 0.0)):
        bk, ik = ck.colmax(r, c, bias, thresh, gain)
        bp, ip = ck.colmax_plain(r, c, bias, thresh, gain)
        torch.testing.assert_close(bk, bp, atol=1e-5, rtol=0)
        assert torch.equal(ik, ip)
