"""Edge-classification and HPNet-style pull/push embedding losses.

Counterpart of `sednet_tpu/losses/edge.py` (reference: src/My_edge_loss.py),
the per-shape and per-class loops written as masked fixed-shape reductions.

One difference from the JAX function: the pull term's distance of a point
to its class centre is `torch.linalg.vector_norm`, whose gradient is 0 where
the distance is 0 (a class of one point), as in the reference's
`torch.norm`. JAX's `jnp.linalg.norm` differentiates sqrt at 0 there and
gives NaN for every gradient; the values agree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def edge_cls_loss(edge_logits, edge_labels, edge_weights):
    """Weighted per-point cross-entropy; shapes whose weights sum to zero are
    dropped (reference: src/My_edge_loss.py:14-25).

    edge_logits: (B, N, 2) raw logits; edge_labels: (B, N) in {0, 1};
    edge_weights: (B, N) per-point BCE weight."""
    logp = F.log_softmax(edge_logits, dim=-1)
    nll = -torch.gather(logp, -1, edge_labels[..., None].long())[..., 0]
    per_shape = (nll * edge_weights).mean(-1)
    per_shape = torch.where(edge_weights.sum(-1) != 0, per_shape, 0.0)
    return per_shape.mean()


def pull_push_embedding_loss(pred_feat, gt_label, t_pull: float = 0.5,
                             t_push: float = 1.5, max_segments: int = 51):
    """HPNet pull/push loss (reference: src/My_edge_loss.py:29-84).

    pred_feat (B, N, E); gt_label (B, N) int, -1 a noise class (class 0).
    pull: mean over classes of mean_i relu(||f_i - center_c|| - t_pull);
    push: mean over present class pairs of relu(t_push - ||c_a - c_b||),
    0 for a shape with one class. Returns (loss, pull, push)."""
    s = max_segments
    cls = gt_label.long() + 1
    seg = torch.arange(s, device=cls.device)
    memberf = (cls[:, None, :] == seg[None, :, None]).to(pred_feat.dtype)
    count = memberf.sum(-1)                                       # (B, S)
    present = count > 0
    centers = torch.einsum("bsn,bne->bse", memberf, pred_feat) / torch.clamp(
        count[..., None], min=1.0)

    own_center = torch.gather(
        centers, 1, cls[..., None].expand(-1, -1, pred_feat.shape[-1]))
    d = torch.linalg.vector_norm(pred_feat - own_center, dim=-1)
    viol = F.relu(d - t_pull)
    per_class = torch.einsum("bsn,bn->bs", memberf, viol) / torch.clamp(
        count, min=1.0)
    n_present = present.sum(-1).to(pred_feat.dtype)
    pull = (per_class * present).sum(-1) / torch.clamp(n_present, min=1.0)

    diff = centers[:, :, None, :] - centers[:, None, :, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    pair_mask = (present[:, :, None] & present[:, None, :]
                 & ~torch.eye(s, dtype=torch.bool, device=cls.device))
    viol = F.relu(t_push - dist) * pair_mask
    n_pairs = pair_mask.sum((-1, -2)).to(pred_feat.dtype)
    push = torch.where(n_pairs > 0, viol.sum((-1, -2))
                       / torch.clamp(n_pairs, min=1.0), 0.0)

    pull_loss, push_loss = pull.mean(), push.mean()
    return pull_loss + push_loss, pull_loss, push_loss


def edge_embedding_loss(edge_logits, pred_feat, gt_label, edges_num: int = 2000,
                        use_type: bool = False, primitives=None,
                        type_log_prob=None, max_segments: int = 51):
    """Pull/push on the `edges_num` most edge-like points (the largest edge
    logits, `torch.topk`: on exact ties its set may differ from
    `lax.top_k`'s), plus, with use_type, the type NLL on the same points
    (reference: src/My_edge_loss.py:89-105)."""
    top_idx = torch.topk(edge_logits[:, :, 1], edges_num, dim=1).indices
    feat = torch.gather(pred_feat, 1,
                        top_idx[..., None].expand(-1, -1, pred_feat.shape[-1]))
    label = torch.gather(gt_label, 1, top_idx)
    loss = pull_push_embedding_loss(feat, label, max_segments=max_segments)[0]
    if not use_type:
        return loss
    lp = torch.gather(type_log_prob, 1, top_idx[..., None].expand(
        -1, -1, type_log_prob.shape[-1]))
    prim = torch.gather(primitives, 1, top_idx)
    nll = -torch.gather(lp, -1, prim[..., None].long())
    return nll.mean() + loss
