"""The port's kernels that `torch.export` traces through, K1 (`sednet::topk`),
K6 (`sednet::gather_reduce`) and K6b (`sednet::gather_reduce_backward`), as
`torch.library` custom ops on the CPU: `torch.library.opcheck` on each (the
schema, the fake implementation against the real one, the autograd
registration, AOT dispatch with dynamic shapes), K6's gradient through the
op against autograd of `gather_reduce_plain` (within 1e-6, ties in the max
included), and the wrappers dispatching to the plain versions without
counting a launch. The CUDA implementations are held to the plain versions
on the card (`tests/test_torch_port_cuda.py -k custom_op`)."""
import numpy as np
import pytest
import torch

from sednet_tpu_torch.ops import graph
from sednet_tpu_torch.ops.flash_topk import flash_topk, topk_plain


def _table(seed, b=2, n=40, c=8, k=6, ties=False):
    rng = np.random.RandomState(seed)
    a = rng.randn(b, n, c).astype(np.float32)
    if ties:   # few distinct values: the max has ties within a row
        a = np.round(a).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int64)
    return torch.from_numpy(a), torch.from_numpy(idx)


@pytest.mark.parametrize("metric,largest,batched", [
    ("sqdist", False, True), ("sqdist", True, False),
    ("points_normals", False, True)])
def test_opcheck_topk(metric, largest, batched):
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 30, 6).astype(np.float32))
    p = torch.from_numpy(rng.randn(2, 40, 6).astype(np.float32))
    if not batched:
        q, p = q[0], p[0]
    torch.library.opcheck(torch.ops.sednet.topk.default,
                          (q, p, 5, metric, 0.5, largest))


@pytest.mark.parametrize("with_order", [False, True])
def test_opcheck_gather_reduce(with_order):
    a, idx = _table(1)
    order = graph.locality_order(a[..., :3]) if with_order else None
    torch.library.opcheck(torch.ops.sednet.gather_reduce.default,
                          (a.requires_grad_(), idx, order))


def test_opcheck_gather_reduce_backward():
    a, idx = _table(2, ties=True)
    s, sq, mx = graph.gather_reduce_plain(a, idx)
    g = [torch.randn(a.shape, generator=torch.Generator().manual_seed(i))
         for i in range(3)]
    torch.library.opcheck(torch.ops.sednet.gather_reduce_backward.default,
                          (a, idx, graph.locality_order(a[..., :3]), mx,
                           *g))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gather_reduce_gradient_matches_plain_autograd(ties, dtype):
    """The op's backward (K6b's op, `gather_reduce_backward_plain` on the
    CPU) against autograd through the materialised gather, with random
    cotangents on all three outputs: within 1e-6 in float64; in float32,
    where the two add the same terms in other orders, within
    `backward_error_bound` (and 1e-6 of the largest element)."""
    a, idx = _table(3, ties=ties)
    a = a.to(dtype)
    cot = [torch.randn(a.shape, generator=torch.Generator().manual_seed(7 + i),
                       dtype=dtype) for i in range(3)]
    x = a.clone().requires_grad_()
    out = graph.gather_reduce(x, idx, graph.locality_order(a[..., :3]))
    torch.autograd.backward(out, cot)
    y = a.clone().requires_grad_()
    torch.autograd.backward(graph.gather_reduce_plain(y, idx), cot)
    # repeated neighbours tie in the max in both cases; the rounded table
    # adds ties between distinct neighbours
    assert (graph.gather_neighbors(a, idx)
            == out[2].detach()[:, :, None]).sum(2).gt(1).any()
    diff = (x.grad - y.grad).abs()
    if dtype == torch.float64:
        assert float(diff.max()) <= 1e-6
    else:
        bound = graph.backward_error_bound(a, idx, out[2].detach(), *cot)
        assert bool((diff <= bound).all())
        assert float(diff.max()) <= 1e-6 * float(y.grad.abs().max())


def test_ops_dispatch_the_plain_versions_on_the_cpu():
    a, idx = _table(4)
    before = (flash_topk.launches, graph.gather_reduce.launches,
              graph.gather_reduce_backward.launches)
    q = a[..., :6].contiguous()
    assert torch.equal(flash_topk(q, q, 5), topk_plain(q, q, 5)[1])
    got = graph.gather_reduce(a.requires_grad_(), idx)
    for g, w in zip(got, graph.gather_reduce_plain(a.detach(), idx)):
        assert torch.equal(g.detach(), w)
    sum(t.sum() for t in got).backward()
    assert (flash_topk.launches, graph.gather_reduce.launches,
            graph.gather_reduce_backward.launches) == before


def test_topk_op_takes_no_gradient():
    q = torch.randn(20, 3, requires_grad=True)
    idx, dist = flash_topk(q, q, 4, return_distances=True)
    assert not dist.requires_grad and idx.dtype == torch.int64


def test_locality_order_caches_nothing_under_fake_tensors():
    """The Morton key is computed in the call (no table cached by device),
    so a trace with fake tensors leaves nothing behind that a later call
    on real tensors would read."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    xyz = torch.rand(2, 50, 3, generator=torch.Generator().manual_seed(5))
    want = graph.locality_order(xyz)
    with FakeTensorMode() as mode:
        fake = graph.locality_order(mode.from_tensor(xyz))
        assert fake.shape == (2, 50) and fake.dtype == torch.int32
    assert torch.equal(graph.locality_order(xyz), want)
