"""The port's IoU losses (sednet_tpu_torch.losses.iou_loss) against
`sednet_tpu/losses/iou_loss.py` on the CPU, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.losses import iou_loss as J
from sednet_tpu_torch.losses import iou_loss as T


def _scores(rng, b=3, c=6, n=120):
    s = rng.rand(b, c, n).astype(np.float32)
    return s / s.sum(1, keepdims=True)


def _one_hot(target, c):
    return np.transpose(np.eye(c, dtype=np.float32)[target], (0, 2, 1))


# reorder_pred_idx on the host, both in float64 numpy: equal arrays; the
# last shape has -1 noise points, which join no GT segment
def test_reorder_pred_idx_matches_jax(rng):
    inputs = _scores(rng)
    target = rng.randint(0, 4, (3, 120))
    target[2, ::7] = -1
    mj, nj = J.reorder_pred_idx(inputs, target)
    mt, nt = T.reorder_pred_idx(inputs, target)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(nt, nj)


# the soft IoU losses, plain, with the matched gather and the GT mask, and
# the weighted one both ways: values at rtol 1e-6 and the gradient of the
# scores against jax.grad at atol 1e-6 (sums of 120 terms in float32)
@pytest.mark.parametrize("kind", ["plain", "matched", "masked", "weighted",
                                  "weighted_abs"])
def test_miou_losses_match_jax(rng, kind):
    c = 6
    inputs = _scores(rng, c=c)
    target = rng.randint(0, 4, (3, 120))
    oh = _one_hot(target, c)
    match, _ = J.reorder_pred_idx(inputs, target)
    midx = np.ascontiguousarray(np.transpose(match, (0, 2, 1)))
    mask = oh.sum(-1) > 0
    kw_j, kw_t = {}, {}
    if kind != "plain":
        kw_j["matching_indices"] = jnp.asarray(midx)
        kw_t["matching_indices"] = torch.from_numpy(midx)
    if kind in ("masked", "weighted", "weighted_abs"):
        kw_j["gt_mask"] = jnp.asarray(mask)
        kw_t["gt_mask"] = torch.from_numpy(mask)
    if kind.startswith("weighted"):
        fj, ft = J.miou_loss_weighted, T.miou_loss_weighted
        kw_j["abs_w"] = kw_t["abs_w"] = kind == "weighted_abs"
    else:
        fj, ft = J.miou_loss, T.miou_loss
    vj, gj = jax.value_and_grad(lambda s: fj(s, jnp.asarray(oh), **kw_j))(
        jnp.asarray(inputs))
    st = torch.from_numpy(inputs).requires_grad_()
    vt = ft(st, torch.from_numpy(oh), **kw_t)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), atol=1e-6)


# miou_loss_edge: the port's three_nn (the plain top-k on the CPU) and
# JAX's pick the same neighbours on these clouds (the 2nd and 3rd
# distances lie more than 2e-7 apart, twice their float32 rounding, which
# is asserted), so the boundary and the loss agree at rtol 1e-6
def test_miou_loss_edge_matches_jax(rng):
    points = rng.uniform(-0.5, 0.5, (2, 200, 3)).astype(np.float32)
    inst = rng.rand(2, 5, 200).astype(np.float32)
    edge = rng.randn(2, 200, 2).astype(np.float32)
    d = np.sort(((points[:, :, None] - points[:, None]) ** 2).sum(-1), -1)
    assert (d[..., 2] - d[..., 1]).min() > 2e-7
    want = J.miou_loss_edge(jnp.asarray(points), jnp.asarray(inst),
                            jnp.asarray(edge))
    got = T.miou_loss_edge(torch.from_numpy(points), torch.from_numpy(inst),
                           torch.from_numpy(edge))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
