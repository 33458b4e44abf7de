"""SplineNet's losses: the control grid's regression invariant to the grid's
symmetries, the reconstruction chamfer, the Laplacian smoothing term.

Counterpart of `sednet_tpu/losses/spline.py` (reference: src/loss.py:12-239).
The open-spline loss takes the least of the 8 symmetries of the grid (4
flips, each transposed or not, :21-38); the closed-spline loss takes the
least of every roll along the closed direction times 4 flips (:41-57,
100-124). The best-aligned ground-truth grid is a gather, so no gradient
flows into the target; on a tie the first symmetry wins the gather and
the min's gradient is split evenly over the tied ones (`torch.amin`), as
JAX's `jnp.argmin` and `jnp.min` do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sednet_tpu_torch.fit.bspline import sample_from_control_grid
from sednet_tpu_torch.ops.chamfer import chamfer_distance, chamfer_index


def _all_permutations(grid):
    """(B, g, g, 3) -> (B, 8, g, g, 3) open-spline symmetries
    (reference: src/loss.py:21-38)."""
    p = [grid, grid.flip(1), grid.flip(2), grid.flip((1, 2))]
    p = p + [q.transpose(1, 2) for q in p]
    return torch.stack(p, 1)


def _all_permutations_half(grid):
    """(B, g, g, 3) -> (B, 4, g, g, 3) closed-spline symmetries
    (reference: src/loss.py:41-57)."""
    return torch.stack([grid, grid.flip(1), grid.flip(2), grid.flip((1, 2))],
                       1)


def _least_over(out, perms, size: int):
    """The mean over the batch of the least squared distance of out
    (B, 1, u, v, 3) to the candidates perms (B, P, u, v, 3), over size, and
    the first candidate that reaches it."""
    diff = ((out - perms) ** 2).sum((2, 3, 4))          # (B, P)
    idx = diff.argmin(1)
    loss = torch.amin(diff, 1).mean() / size
    best = perms[torch.arange(perms.shape[0], device=perms.device), idx]
    return loss, best.detach()


def control_points_permute_loss(output, control_points, grid_size: int):
    """Least over the 8 open-spline symmetries (reference:
    src/loss.py:76-97). output (B, g*g, 3), control_points (B, g, g, 3).
    Returns (loss, best-aligned ground truth (B, g, g, 3))."""
    b = output.shape[0]
    out = output.reshape(b, grid_size, grid_size, 3)[:, None]
    return _least_over(out, _all_permutations(control_points),
                       grid_size * grid_size * 3)


def control_points_permute_closed_loss(output, control_points, grid_u: int,
                                       grid_v: int):
    """Least over grid_v rolls x 4 symmetries, for closed splines
    (reference: src/loss.py:100-124)."""
    b = output.shape[0]
    out = output.reshape(b, grid_u, grid_v, 3)[:, None]
    perms = torch.cat([_all_permutations_half(torch.roll(control_points, i,
                                                         dims=1))
                       for i in range(grid_v)], 1)
    return _least_over(out, perms, grid_u * grid_v * 3)


def _surface(nu, nv, control):
    nu = torch.as_tensor(nu, device=control.device)
    nv = torch.as_tensor(nv, device=control.device)
    return sample_from_control_grid(nu, nv, control, nu.shape[1],
                                    nv.shape[1])


def spline_reconstruction_loss(nu, nv, control, points, *, sqrt=False):
    """Chamfer between the surface sampled from the predicted grid and the
    points (reference: src/loss.py:167-187). nu, nv: basis matrices (numpy
    or tensors); control (B, cu*cv, 3); points (B, N, 3). Returns (loss,
    surface samples)."""
    reconst = _surface(nu, nv, control)
    return chamfer_distance(reconst, points, sqrt=sqrt), reconst


def spline_reconstruction_loss_one_sided(nu, nv, control, points, *, side=1):
    """One-sided chamfer (reference: src/loss.py:142-165 and
    src/utils.py:299-323). side=1: for every point, the nearest surface
    sample (the prediction must cover the patch), the mean of d2; side=0
    the reverse. Returns (loss, surface samples)."""
    reconst = _surface(nu, nv, control)
    d1, d2 = chamfer_index(reconst, points)
    return (d2.mean() if side == 1 else d1.mean()), reconst


def laplacian_loss(output, gt, dist_type: str = "l2"):
    """The 4-neighbour Laplacian of the predicted grid against the ground
    truth's (reference: src/loss.py:213-239). output, gt: (B, g, g, 3).
    The Laplacian is a 3x3 convolution with zero padding ("SAME") of each
    coordinate plane, on the (B*3, 1, g, g) layout."""
    k = torch.tensor([[0.0, 0.25, 0.0], [0.25, -1.0, 0.25], [0.0, 0.25, 0.0]],
                     dtype=output.dtype, device=output.device)[None, None]

    def lap(x):
        b, gu, gv, _ = x.shape
        xc = x.permute(0, 3, 1, 2).reshape(b * 3, 1, gu, gv)
        return F.conv2d(xc, k, padding=1).reshape(b, 3, gu, gv)

    d = lap(output) - lap(gt)
    d = d * d if dist_type == "l2" else d.abs()
    return d.sum(1).mean()
