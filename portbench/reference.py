"""The plain reference of the benchmark's cells, in PyTorch and NumPy.

It is written from the published equations of SED-Net (reference repo
yuanqili78/SED-Net: src/SEDNet.py, src/PointNet.py, src/mean_shift.py,
src/smooth_normal_matrix.py, src/segment_loss.py, src/My_edge_loss.py,
src/segment_utils.py) and imports nothing of the program under test.
No kernels, no caches: every kNN graph is a dense distance product and a
top-k, every edge convolution runs on the materialised (N, K, 2C) edge
features, every mean-shift step on the dense (N, N) kernel matrix.

Weights are flax-layout arrays keyed "a/b/kernel" ((in, out)), "a/b/bias"
and "a/b/scale", the layout of the checkpoint file both sides read.

Every product goes through `Prec.mm`, which rounds its inputs to the
precision asked for: "f32" (no rounding; the module turns TF32 off),
"tf32" (10 mantissa bits, what the tensor cores take), "bf16", or "fp8"
(e4m3 with a scale per tensor). The lower ones are the controls of the
`correct` check.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _round_mantissa(t, bits: int):
    """Round float32 t to `bits` explicit mantissa bits, to nearest with
    ties away from zero (the tensor cores' TF32 conversion)."""
    i = t.contiguous().view(torch.int32)
    drop = 23 - bits
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


class Prec:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, t):
        if self.name == "f32":
            return t
        if self.name == "tf32":
            # the rounded value, with the gradient passed straight through
            return t + (_round_mantissa(t.detach().float(), 10) - t).detach()
        if self.name == "bf16":
            return t.to(torch.bfloat16).float()
        scale = torch.clamp_min(t.abs().amax(), 1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a, b):
        return self.round(a) @ self.round(b)


F32 = Prec("f32")


# --------------------------------------------------------------- the model

def sqdist(q, p, prec=F32):
    """(R, N) squared distances |q|^2 - 2 q.p + |p|^2."""
    return ((q * q).sum(-1)[:, None] - 2.0 * prec.mm(q, p.T)
            + (p * p).sum(-1)[None, :])


def knn(x, k: int, prec=F32, row_block: int = 2048):
    """(N, D) -> (N, k) ids of the k nearest rows, self included."""
    return torch.cat([torch.topk(sqdist(x[r:r + row_block], x, prec), k,
                                 dim=1, largest=False).indices
                      for r in range(0, x.shape[0], row_block)])


def knn_points_normals(x, k: int, w: float, prec=F32, row_block: int = 2048):
    """The first layer's graph (src/PointNet.py:90-137): distances
    d_p (1 + w d_n), d_p the squared distance of the positions and
    d_n = 2 - 2 n_i.n_j of the normals."""
    xyz, nrm = x[:, :3], x[:, 3:6]
    out = []
    for r in range(0, x.shape[0], row_block):
        dp = sqdist(xyz[r:r + row_block], xyz, prec)
        dn = 2.0 - 2.0 * prec.mm(nrm[r:r + row_block], nrm.T)
        out.append(torch.topk(dp * (1.0 + w * dn), k, dim=1,
                              largest=False).indices)
    return torch.cat(out)


def group_norm(x, scale, bias, groups: int, eps: float = 1e-6):
    """GroupNorm over every axis but the first (the cloud) within each
    group of channels."""
    shape = x.shape
    g = x.reshape(shape[0], -1, groups, shape[-1] // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp_min((g * g).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, 0.0)
    y = (g - mean) * torch.rsqrt(var + eps)
    return y.reshape(shape) * scale + bias


def dense(w, name, x, prec=F32):
    y = prec.mm(x.reshape(-1, x.shape[-1]), w[name + "/kernel"])
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    return y + w[name + "/bias"] if name + "/bias" in w else y


def gn(w, name, x, groups):
    return group_norm(x, w[name + "/scale"], w[name + "/bias"], groups)


def edge_conv(w, name, x, idx, prec=F32):
    """x (B, N, C), idx (B, N, K): max over K of LeakyReLU(GN([x_j - x_i,
    x_i] W))."""
    xj = torch.stack([x[b][idx[b]] for b in range(x.shape[0])])
    xi = x[:, :, None, :].expand_as(xj)
    f = dense(w, name + "/conv", torch.cat([xj - xi, xi], -1), prec)
    f = gn(w, name + "/gn", f, 2)
    return F.leaky_relu(f, 0.2).amax(dim=2)


def sednet(w, x, *, k: int = 64, normal_w: float = 1.0,
           w_pos: float = 0.2, prec=F32, graph1=None):
    """SEDNet (src/SEDNet.py:216-343, mode 5) on x (B, N, 6). graph1: the
    first-layer graph, built here when not given. Returns
    (type log-probs, embedding, edge logits, graph1)."""
    b = x.shape[0]
    if graph1 is None:
        graph1 = torch.stack([knn_points_normals(x[i], k, normal_w, prec)
                              for i in range(b)])
    x1 = edge_conv(w, "encoder/conv1", x, graph1, prec)
    g2 = torch.stack([knn(x1[i].detach(), k, prec) for i in range(b)])
    x2 = edge_conv(w, "encoder/conv2", x1, g2, prec)
    g3 = torch.stack([knn(x2[i].detach(), k, prec) for i in range(b)])
    x3 = edge_conv(w, "encoder/conv3", x2, g3, prec)
    feats = torch.cat([x1, x2, x3], -1)
    h = F.relu(gn(w, "encoder/gn_mlp1", dense(w, "encoder/mlp1", feats, prec), 8))
    glob = h.amax(dim=1)
    n = x.shape[1]
    y = torch.cat([glob[:, None, :].expand(b, n, -1), feats], -1)
    y = F.relu(gn(w, "gn1", dense(w, "conv1", y, prec), 8))
    x_all = F.relu(gn(w, "gn2", dense(w, "conv2", y, prec), 4))
    x_type = F.relu(gn(w, "gn_prim", dense(w, "mlp_prim_prob1", x_all, prec), 4))
    type_logits = dense(w, "mlp_prim_prob2", x_type, prec)
    e = gn(w, "edge_gn", dense(w, "edge_conv1", x_type, prec), 4)
    edge_logits = dense(w, "edge_conv2", e, prec)
    s = F.relu(gn(w, "gn_seg", dense(w, "mlp_seg_prob1", x_all, prec), 4))
    s = s + w_pos * F.relu(gn(w, "asis_gn", dense(w, "asis_conv", x_type, prec), 4))
    fuse = torch.cat([type_logits, edge_logits], -1).detach()
    s = s + w_pos * F.relu(dense(w, "prim_encoding", fuse, prec))
    emb = dense(w, "mlp_seg_prob2", s, prec)
    return F.log_softmax(type_logits, -1), emb, edge_logits, graph1


# ------------------------------------------------- enrichment and clustering

def entropy(feat, prec=F32, row_block: int = 2048):
    """Pairwise-distance entropy of a feature set (N, C)
    (src/smooth_normal_matrix.py:95-154)."""
    n = feat.shape[0]
    interval = feat.max(0).values - feat.min(0).values
    g = feat / torch.where(interval == 0, torch.ones_like(interval), interval)

    def dist(r):
        return torch.sqrt(torch.clamp_min(sqdist(g[r:r + row_block], g, prec), 0.0))

    blocks = range(0, n, row_block)
    alpha = -math.log(0.5) / (sum(dist(r).sum() for r in blocks) / (n * n))
    ent = 0.0
    for r in blocks:
        s = torch.exp(-alpha * dist(r))
        ent = ent + (-s * torch.log(s + 1e-7)
                     - (1 - s) * torch.log(1 - s + 1e-7)).sum()
    return ent / (n * n)


def farthest(xyz, k: int = 50, prec=F32, row_block: int = 2048,
             direct: bool = False):
    """(N, 3) -> (N, k) ids of each point's k FARTHEST points, largest
    first. direct: the squared distances summed from the differences, the
    same distances rounded another way (a witness for near-ties)."""
    def dist(q):
        if direct:
            return ((q[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        return sqdist(q, xyz, prec)

    return torch.cat([torch.topk(dist(xyz[r:r + row_block]), k, dim=1,
                                 largest=True).indices
                      for r in range(0, xyz.shape[0], row_block)])


def normal_affinity(xyz, normals, sigma: float = 0.1, k: int = 50,
                    prec=F32, dense: bool = True, row_block: int = 2048,
                    idx=None):
    """The normal-angle affinity (src/smooth_normal_matrix.py:42-92) as a
    dense matrix in the inputs' dtype: over each point's k FARTHEST points
    (the reference takes the top-k of the distances, largest first; idx:
    that graph, when given), w = exp(-arccos(n_i.n_j)^2 / 2 sigma^2) with
    the cosine clipped at 0.99. dense: the reference's form, with a 1e-12
    background (weights that underflow become 1e-12), A = (W + W^T) / 2
    normalised by D^-1/2 of the filled row sums. Not dense: the form of
    the matrix-free solve that clouds above 16384 points take (the
    port's, after the JAX package), W normalised by D^-1/2 of its row
    sums (at least 1e-12), then (A + A^T) / 2, with no background."""
    n = xyz.shape[0]
    if idx is None:
        idx = farthest(xyz, k, prec, row_block)
    cos = torch.clamp((prec.round(normals)[:, None, :]
                       * prec.round(normals)[idx]).sum(-1), -0.99, 0.99)
    w = torch.exp(-torch.arccos(cos) ** 2 / (2.0 * sigma * sigma))
    rows = torch.arange(n, device=xyz.device)[:, None]
    a = torch.zeros((n, n), device=xyz.device, dtype=xyz.dtype)
    if not dense:
        rsq = torch.rsqrt(torch.clamp_min(w.sum(-1), 1e-12))
        a[rows, idx] = w * rsq[:, None] * rsq[idx] * 0.5
        return a + a.T
    # a weight that float32 rounds to 0 becomes the background, in any dtype
    w = torch.where(w.float() == 0.0, torch.full_like(w, 1e-12), w)
    d = torch.rsqrt(w.sum(-1) + 1e-12 * (n - k))
    a[rows, idx] = (w - 1e-12) * 0.5
    a = a + a.T + 1e-12
    return a * d[:, None] * d[None, :]


def lobpcg(a, x0, iters: int = 10, prec=F32):
    """Top-k Ritz pairs of the symmetric a from the start block x0 (n, k):
    Rayleigh-Ritz on the orthonormalised block [X, R, P] each iteration.
    Returns (theta (k,), U (n, k))."""
    k = x0.shape[1]
    x = torch.linalg.qr(x0).Q
    p = None
    theta = None
    for _ in range(iters):
        ax = prec.mm(a, x)
        r = ax - x * (x * ax).sum(0, keepdim=True)
        s = torch.linalg.qr(torch.cat([x, r] + ([p] if p is not None else []),
                                      1)).Q
        t = s.T @ prec.mm(a, s)
        w, v = torch.linalg.eigh((t + t.T) / 2)
        theta, top = w[-k:].flip(0), v[:, -k:].flip(1)
        xn = s @ top
        p = xn - x @ (x.T @ xn)
        x = xn
    return theta, x


def ritz_gap(a, theta, u) -> float:
    """How far the Ritz pairs (theta, u) are from being Ritz pairs of a:
    |U^T a U - diag(theta)|_F / |theta|, with U's columns unit."""
    u = u / torch.linalg.vector_norm(u, dim=0, keepdim=True)
    b = u.T @ (a @ u)
    return float(torch.linalg.matrix_norm(b - torch.diag(theta))
                 / torch.linalg.vector_norm(theta))


def enrich(emb, v, smooth_w: float = 0.5, prec=F32):
    """HPNet's entropy-weighted concatenation [emb, v], rows unit
    (src/smooth_normal_matrix.py:157-232)."""
    e = torch.cat([emb * (1.7 - entropy(emb, prec)),
                   v * (smooth_w - entropy(v, prec))], -1)
    return e / torch.clamp_min(e.norm(dim=-1, keepdim=True), 1e-12)


def bandwidth(x, quantile: float, prec=F32, row_block: int = 2048):
    """Mean square root of each row's k-th smallest squared distance to
    the rows (self included), k = quantile * N, at least 0.003
    (src/mean_shift.py:19-43 with the guard's clip), over the rows x of
    the subsample."""
    from portbench.counts import bandwidth_k
    k = bandwidth_k(quantile, x.shape[0])
    kth = torch.cat([torch.topk(sqdist(x[r:r + row_block], x, prec), k,
                                dim=1, largest=False).values[:, k - 1]
                     for r in range(0, x.shape[0], row_block)])
    return max(float(torch.sqrt(torch.clamp_min(kth, 1e-6)).mean()), 0.003)


def shift_step(cur, x, inv_b2: float, prec=F32, row_block: int = 2048):
    """One gaussian mean-shift step of the rows cur against x
    (src/mean_shift.py:60-75)."""
    out = []
    for r in range(0, cur.shape[0], row_block):
        k = torch.exp(torch.clamp_min((prec.mm(cur[r:r + row_block], x.T) - 1.0)
                                      * inv_b2, -75.0))
        o = prec.mm(k, x) / torch.clamp_min(k.sum(1, keepdim=True), 1e-30)
        out.append(o / torch.sqrt(torch.clamp_min((o * o).sum(1, keepdim=True),
                                                  1e-24)))
    return torch.cat(out)


def mean_shift(xs, bws, iterations: int = 50, tol: float = 1e-6, prec=F32):
    """Shift every cloud of the batch xs (B, N, E) at its bandwidth,
    stopping after the first step in which no coordinate of the batch
    moved by more than tol. Returns (shifted, steps run)."""
    cur = xs
    for step in range(1, iterations + 1):
        nxt = torch.stack([shift_step(cur[i], xs[i], 1.0 / (bws[i] * bws[i]),
                                      prec) for i in range(xs.shape[0])])
        moved = float((nxt - cur).abs().max())
        cur = nxt
        if moved <= tol:
            return cur, step
    return cur, iterations


def _colmax(rows, cols, bias, thresh, gain, prec=F32, row_block: int = 2048):
    """For each row, the first column maximising gain * sim + bias among
    the columns with 2 - 2 sim < thresh."""
    out = []
    for r in range(0, rows.shape[0], row_block):
        sim = prec.mm(rows[r:r + row_block], cols.T)
        scored = torch.where(2.0 - 2.0 * sim < thresh, gain * sim + bias[None, :],
                             torch.full_like(sim, -math.inf))
        out.append(scored.argmax(dim=1))
    return torch.cat(out)


def nms(shifted, x, bw: float, prec=F32):
    """Non-maximum suppression of the shifted points
    (src/mean_shift.py:139-179): every point's nearest shifted point, the
    occupied ones voting within the bandwidth for their heaviest
    neighbour, then each point to its most aligned surviving center.
    Returns (labels (N,), number of clusters)."""
    n = x.shape[0]
    zeros = torch.zeros(n, device=x.device)
    member = _colmax(x, shifted, zeros, math.inf, 1.0, prec)
    counts = torch.bincount(member, minlength=n).float()
    rep = _colmax(shifted, shifted, counts, bw, 0.0, prec)
    mask = torch.zeros(n, dtype=torch.bool, device=x.device)
    mask[rep[counts > 0]] = True
    raw = _colmax(x, shifted, torch.where(mask, 0.0, -math.inf), math.inf,
                  1.0, prec)
    return (torch.cumsum(mask.long(), 0) - 1)[raw], int(mask.sum())


# ------------------------------------------------------------------ metrics

def _remap_eval(t):
    t = t.copy()
    t[(t == 0) | (t == 6) | (t == 7)] = 9
    t[t == 8] = 2
    return t


def matched_metrics(gt_labels, gt_prim, labels, types, points, device="cpu"):
    """Hungarian-matched segment IoU, type accuracy and chamfer recall of
    one cloud (src/segment_utils.py:194-242, generate_predictions_aug.py):
    the cost is 1 - relaxed IoU of the one-hot ids below 50, in float32;
    recall is the share of true segments whose matched prediction lies
    within 0.1 of half the symmetric chamfer distance."""
    seg = np.arange(50)
    ph = (labels[:, None] == seg).astype(np.float32)
    gh = (gt_labels[:, None] == seg).astype(np.float32)
    dots = ph.T @ gh
    cost = 1.0 - dots / (ph.sum(0)[:, None] + gh.sum(0)[None, :] - dots
                         + np.float32(1e-7))
    rows, cols = linear_sum_assignment(cost)
    tp_rm = _remap_eval(types.astype(np.int64))
    per_seg = np.bincount(labels * 10 + tp_rm, minlength=500).reshape(50, 10
                                                                      ).argmax(1)
    gt_rm = _remap_eval(gt_prim.astype(np.int64))
    ious, oks, hits = [], [], 0
    for r, c in zip(rows, cols):
        pi, gi = labels == r, gt_labels == c
        if not pi.any() or not gi.any():
            continue
        ious.append((pi & gi).sum() / ((pi | gi).sum() + 1e-8))
        oks.append(gt_rm[gi][0] == per_seg[r])
        a = torch.from_numpy(points[pi]).to(device, torch.float64)
        b = torch.from_numpy(points[gi]).to(device, torch.float64)
        d1 = torch.cat([torch.cdist(a[i:i + 4096], b).min(1).values ** 2
                        for i in range(0, a.shape[0], 4096)])
        d2 = torch.cat([torch.cdist(b[i:i + 4096], a).min(1).values ** 2
                        for i in range(0, b.shape[0], 4096)])
        hits += int(float(0.5 * (d1.mean() + d2.mean())) / 2.0 < 0.1)

    def mean(v):
        return float(np.mean(v)) if v else float("nan")

    return mean(ious), mean(oks), hits / np.unique(gt_labels).shape[0]


# ------------------------------------------------------------------ training

def sample_draws(labels, generator, max_segments: int = 50,
                 samples: int = 30, pairs: int = 25):
    """The triplet loss's draws from `generator` (CPU): per cloud and
    segment `samples` member ids uniform with replacement, and `pairs`
    segment pairs uniform over the present segments
    (src/segment_loss.py:21-126)."""
    b, n = labels.shape
    s = max_segments
    lab = labels.long()
    count = (lab[:, None, :] == torch.arange(s, device=lab.device)[None, :, None]).sum(-1)
    members = torch.sort(lab, dim=1, stable=True).indices
    start = torch.cumsum(count, 1) - count

    def pick(cnt, u):
        return torch.minimum((u * cnt).long(), (cnt - 1).clamp_min(0))

    u = torch.rand((b, s, samples), generator=generator).to(lab.device)
    pos = (start[..., None] + pick(count[..., None], u)).clamp_max(n - 1)
    idx = torch.gather(members, 1, pos.reshape(b, -1)).reshape(b, s, samples)
    present = count > 0
    ids = torch.sort((~present).to(torch.uint8), dim=1, stable=True).indices
    n_present = present.sum(-1, keepdim=True)
    seg = [torch.gather(ids, 1, pick(n_present, torch.rand(
        (b, pairs), generator=generator).to(lab.device))) for _ in range(2)]
    return idx, seg[0], seg[1]


def triplet_loss(emb, labels, draws, margin: float = 1.0, max_segments: int = 50):
    idx, seg_a, seg_b = draws
    b = emb.shape[0]
    e = emb / torch.clamp_min(emb.norm(dim=-1, keepdim=True), 1e-12)
    rows = torch.arange(b, device=emb.device)
    samples = e[rows[:, None, None], idx]
    pa, pb = samples[rows[:, None], seg_a], samples[rows[:, None], seg_b]
    valid = (seg_a != seg_b).float()

    def sq(u, v):
        return ((u[:, :, :, None, :] - v[:, :, None, :, :]) ** 2).sum(-1)

    c = F.relu(sq(pa, pa) - sq(pa, pb) + margin)
    loss = c.sum((-1, -2)) - torch.diagonal(c, dim1=-2, dim2=-1).sum(-1)
    loss = loss / ((c > 0).sum((-1, -2)).float() + 1.0).detach() * valid
    shape_loss = loss.sum(-1) / (valid.sum(-1) + 1e-8)
    present = (labels.long()[:, None, :] == torch.arange(
        max_segments, device=labels.device)[None, :, None]).any(-1)
    ok = (present.sum(-1) > 1).float()
    return (shape_loss * ok).sum() / (ok.sum() + 1e-8)


def _nll(lp, target):
    return -torch.gather(lp, -1, target[..., None].long())[..., 0]


def pull_push(feat, labels, max_segments: int = 51):
    """HPNet's pull/push loss (src/My_edge_loss.py:29-84)."""
    cls = labels.long() + 1
    m = (cls[:, None, :] == torch.arange(max_segments, device=cls.device)[None, :, None]).float()
    count = m.sum(-1)
    present = count > 0
    centers = torch.einsum("bsn,bne->bse", m, feat) / torch.clamp_min(count[..., None], 1.0)
    own = torch.gather(centers, 1, cls[..., None].expand(-1, -1, feat.shape[-1]))
    viol = F.relu(torch.linalg.vector_norm(feat - own, dim=-1) - 0.5)
    per_class = torch.einsum("bsn,bn->bs", m, viol) / torch.clamp_min(count, 1.0)
    pull = (per_class * present).sum(-1) / torch.clamp_min(present.sum(-1).float(), 1.0)
    diff = centers[:, :, None, :] - centers[:, None, :, :]
    dist = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 1e-12))
    pm = present[:, :, None] & present[:, None, :] & ~torch.eye(
        max_segments, dtype=torch.bool, device=cls.device)
    n_pairs = pm.sum((-1, -2)).float()
    push = torch.where(n_pairs > 0, (F.relu(1.5 - dist) * pm).sum((-1, -2))
                       / torch.clamp_min(n_pairs, 1.0), 0.0)
    return pull.mean() + push.mean()


def sednet_loss(w, batch, draws, *, k: int = 64, smooth: float = 0.025,
                edge_topk: int = 2000, w_edge_embed: float = 0.25, prec=F32):
    """SED-Net's four-term training loss (train_sed_net.py): the triplet
    embedding loss, the label-smoothed type NLL, the weighted edge
    cross-entropy and the pull/push loss with the type NLL on the most
    edge-like points."""
    x = torch.cat([batch["points"], batch["normals"]], -1)
    lp, emb, edge, _ = sednet(w, x, k=k, prec=prec)
    prim = batch["prim"].long()
    prim = torch.where((prim == 9) | (prim == 6) | (prim == 7), 0, prim)
    prim = torch.where(prim == 8, 2, prim)
    labels = batch["labels"]
    t_loss = triplet_loss(emb, labels, draws)
    p_loss = ((1 - smooth) * _nll(lp, prim) - smooth * lp.mean(-1)).mean()
    ew = batch["edges_w"]
    per = (_nll(F.log_softmax(edge, -1), batch["edges"]) * ew).mean(-1)
    e_loss = torch.where(ew.sum(-1) != 0, per, 0.0).mean()
    top = torch.topk(edge[:, :, 1], edge_topk, dim=1).indices
    feat = torch.gather(emb, 1, top[..., None].expand(-1, -1, emb.shape[-1]))
    ee = pull_push(feat, torch.gather(labels, 1, top))
    lp_top = torch.gather(lp, 1, top[..., None].expand(-1, -1, lp.shape[-1]))
    ee = ee + _nll(lp_top, torch.gather(prim, 1, top)).mean()
    return t_loss + p_loss + e_loss + w_edge_embed * ee


class AdamW:
    """AdamW (Loshchilov and Hutter) with bias correction, as the reference
    trains: decay p by lr * wd, then p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: dict, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr / bc1 * self.m[k]
                   / (self.v[k].sqrt() / math.sqrt(bc2) + self.eps))
