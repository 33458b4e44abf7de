"""Triplet embedding loss, fixed-shape.

Counterpart of `sednet_tpu/losses/embedding.py` (reference:
src/segment_loss.py:21-126 EmbeddingLoss.triplet_loss), with the same
semantics:
  * `samples_per_segment` (30) points drawn per GT segment, with
    replacement;
  * `num_pairs` (25) random (seg_a, seg_b) draws over the present segments,
    pairs with a == b skipped;
  * per-pair loss relu(d_pos - d_neg + margin) with the diagonal removed,
    divided by (#violations + 1), that count detached;
  * normalised by the valid pair count, then over the shapes with more than
    one segment.

JAX draws the samples and the pairs with `jax.random.categorical`
(`sednet_tpu/losses/embedding.py:62-71`). The port takes them as
`draws=(sample_idx (B, S, M), seg_a (B, P), seg_b (B, P))`, as the tests
feed JAX's, or draws them itself from an explicit `torch.Generator`
(`sample_draws`).

Labels must be canonical: integers in [0, cfg.max_segments).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class TripletConfig:
    margin: float = 1.0
    max_segments: int = 50
    samples_per_segment: int = 30
    num_pairs: int = 25  # reference: max_segments(5)^2 iterations


def _uniform_pick(count, u):
    """floor(u * count) kept in [0, count - 1] (0 where count is 0)."""
    r = (u * count).long()
    return torch.minimum(r, (count - 1).clamp_min(0))


def sample_draws(labels, cfg: TripletConfig, generator: torch.Generator):
    """The triplet loss's random draws, on labels' device, from uniform
    numbers that `generator` gives on its own device: for every shape and
    segment, `samples_per_segment` indices uniform with replacement over the
    segment's points (any valid index for an absent segment, whose samples
    no pair uses); and `num_pairs` segments a and b, each uniform over the
    present segments. Returns (sample_idx (B, S, M), seg_a (B, P),
    seg_b (B, P)), int64."""
    b, n = labels.shape
    s, m, p = cfg.max_segments, cfg.samples_per_segment, cfg.num_pairs
    dev, gdev = labels.device, generator.device
    lab = labels.long()
    count = (lab[:, None, :] == torch.arange(s, device=dev)[None, :, None]
             ).sum(-1)                                            # (B, S)
    members = torch.sort(lab, dim=1, stable=True).indices        # by segment
    start = torch.cumsum(count, 1) - count
    u = torch.rand((b, s, m), generator=generator, device=gdev).to(dev)
    pos = (start[..., None] + _uniform_pick(count[..., None], u)).clamp_max(
        n - 1)
    sample_idx = torch.gather(members, 1, pos.reshape(b, s * m)).reshape(
        b, s, m)

    present = count > 0
    present_ids = torch.sort((~present).to(torch.uint8), dim=1,
                             stable=True).indices                 # present first
    n_present = present.sum(-1, keepdim=True)
    segs = []
    for _ in range(2):
        u = torch.rand((b, p), generator=generator, device=gdev).to(dev)
        segs.append(torch.gather(present_ids, 1,
                                 _uniform_pick(n_present, u)))
    return sample_idx, segs[0], segs[1]


def triplet_loss(embedding, labels, cfg: TripletConfig = TripletConfig(), *,
                 draws=None, generator: torch.Generator | None = None):
    """embedding (B, N, E), labels (B, N) in [0, cfg.max_segments).
    draws: (sample_idx, seg_a, seg_b) as `sample_draws` returns them, or
    None to draw them from `generator`. Returns the scalar loss."""
    b, n, e = embedding.shape
    s = cfg.max_segments
    if draws is None:
        if generator is None:
            raise ValueError("triplet_loss: pass draws or a generator")
        draws = sample_draws(labels, cfg, generator)
    sample_idx, seg_a, seg_b = (t.to(embedding.device).long() for t in draws)
    emb = embedding / torch.clamp(
        torch.linalg.vector_norm(embedding, dim=-1, keepdim=True), min=1e-12)

    seg_ids = torch.arange(s, device=labels.device)
    present = (labels.long()[:, None, :] == seg_ids[None, :, None]).any(-1)

    rows = torch.arange(b, device=embedding.device)
    samples = emb[rows[:, None, None], sample_idx]                # (B, S, M, E)
    valid_pair = (seg_a != seg_b).to(emb.dtype)                   # (B, P)
    pred_a = samples[rows[:, None], seg_a]                        # (B, P, M, E)
    pred_b = samples[rows[:, None], seg_b]

    def sqd(u, v):
        return ((u[:, :, :, None, :] - v[:, :, None, :, :]) ** 2).sum(-1)

    constraint = F.relu(sqd(pred_a, pred_a) - sqd(pred_a, pred_b) + cfg.margin)
    pair_loss = (constraint.sum((-1, -2))
                 - torch.diagonal(constraint, dim1=-2, dim2=-1).sum(-1))
    satisfied = (constraint > 0).sum((-1, -2)).to(emb.dtype) + 1.0
    pair_loss = pair_loss / satisfied.detach() * valid_pair

    shape_loss = pair_loss.sum(-1) / (valid_pair.sum(-1) + 1e-8)
    shape_valid = (present.sum(-1) > 1).to(emb.dtype)
    return (shape_loss * shape_valid).sum() / (shape_valid.sum() + 1e-8)
