"""The benchmark's frozen input generator: CAD-like clouds from analytic
primitives, normalised and PCA-aligned, and the train feed's plain copy.

The samplers follow the port's `data/synthetic.py` (types 1 plane, 3 cone,
4 cylinder, 5 sphere, the reference vocabulary), with two changes that
belong to the benchmark: the segment counts of a pool are spread evenly
over the traffic's range (SED-Net's test set holds clouds of up to 49
segments; the port's own generator draws 3-7), and a boundary point's distance to
the nearest point of another segment comes from a k-d tree, so that a
pool of clouds with edge labels takes a fraction of a second a cloud.

`feed_batches` is a plain copy of the train feed that the port runs
behind its prefetcher (a shuffled order per epoch, then per cloud:
extent scaling, the reference's augmentation, PCA alignment, instance
ids made canonical, a random point order), so that the reference can
work the batches of a train step out again from the pool and the seed.
Nothing here imports the port.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

EPS = np.finfo(np.float32).eps
TYPES = (1, 3, 4, 5)


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _orthobasis(rng):
    a = _unit(rng.randn(3))
    h = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = _unit(np.cross(a, h))
    return a, u, np.cross(a, u)


def _plane(rng, n):
    a, u, v = _orthobasis(rng)
    origin = rng.randn(3) * 0.3
    s = rng.uniform(-0.5, 0.5, (n, 2))
    return origin + s[:, :1] * u + s[:, 1:] * v, np.tile(a, (n, 1))


def _sphere(rng, n):
    center = rng.randn(3) * 0.3
    r = rng.uniform(0.2, 0.6)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return center + r * d, d


def _cylinder(rng, n):
    a, u, v = _orthobasis(rng)
    center = rng.randn(3) * 0.3
    r = rng.uniform(0.15, 0.5)
    h = rng.uniform(0.4, 1.0)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-h / 2, h / 2, n)
    radial = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * v
    return center + r * radial + z[:, None] * a, radial


def _cone(rng, n):
    a, u, v = _orthobasis(rng)
    apex = rng.randn(3) * 0.3
    theta = rng.uniform(0.2, 0.9)
    h = rng.uniform(0.4, 1.0)
    t = np.sqrt(rng.uniform(0.05, 1.0, n)) * h
    phi = rng.uniform(0, 2 * np.pi, n)
    radial = np.cos(phi)[:, None] * u + np.sin(phi)[:, None] * v
    pts = apex + t[:, None] * a + (t * np.tan(theta))[:, None] * radial
    return pts, np.cos(theta) * radial - np.sin(theta) * a


_SAMPLERS = {1: _plane, 3: _cone, 4: _cylinder, 5: _sphere}


def normalize_points(points):
    """Mean-centre and scale by the largest axis extent."""
    points = points - points.mean(0, keepdims=True)
    extent = points.max(0) - points.min(0)
    return points / (extent.max() + EPS)


def _rotation_a_to_b(a, b):
    cos = float(np.dot(a, b))
    sin = float(np.linalg.norm(np.cross(b, a)))
    v = b - np.dot(a, b) * a
    v = v / (np.linalg.norm(v) + EPS)
    w = np.cross(b, a)
    w = w / (np.linalg.norm(w) + EPS)
    f = np.stack([a, v, w], 1)
    g = np.array([[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]])
    try:
        return f @ g @ np.linalg.inv(f)
    except np.linalg.LinAlgError:
        return np.eye(3, dtype=np.float32)


def pca_align(points, normals):
    """Rotate so that the smallest principal axis maps to +x."""
    s, u = np.linalg.eig(points.T @ points)
    smallest = np.real(u[:, np.argmin(np.real(s))])
    r = _rotation_a_to_b(smallest, np.array([1.0, 0.0, 0.0]))
    return points @ r.T, normals @ r.T


def segment_counts(count: int, segments) -> list:
    """The segment counts of a pool of `count` clouds: spread evenly over
    the closed range `segments`, the same for every seed, so that a seed
    changes the shapes and their order but not the amount of work."""
    lo, hi = segments
    return [lo + (i * (hi - lo + 1)) // count for i in range(count)]


def make_cloud(rng, n_points: int, k: int, edges: bool):
    """One cloud of n_points points in k segments: points, normals (N, 3)
    float32, labels, prim (N,) int32 and, with `edges`, the boundary flags
    and their weights."""
    types = rng.choice(TYPES, size=k)
    counts = np.full(k, n_points // k)
    counts[: n_points - counts.sum()] += 1
    pts, nrm, labels, prim = [], [], [], []
    for i, (t, c) in enumerate(zip(types, counts)):
        p, nr = _SAMPLERS[int(t)](rng, int(c))
        pts.append(p)
        nrm.append(nr)
        labels.append(np.full(c, i, np.int32))
        prim.append(np.full(c, t, np.int32))
    out = {"points": np.concatenate(pts).astype(np.float32),
           "normals": np.concatenate(nrm).astype(np.float32),
           "labels": np.concatenate(labels), "prim": np.concatenate(prim)}
    if edges:
        points, labels = out["points"], out["labels"]
        min_other = np.full(n_points, np.inf)
        for i in range(k):
            own = labels == i
            other = points[~own][::3]
            if other.shape[0]:
                min_other[own] = cKDTree(other).query(points[own])[0]
        thresh = max(0.03, float(np.percentile(min_other, 8)))
        out["edges"] = (min_other < thresh).astype(np.int32)
        out["edges_w"] = np.ones(n_points, np.float32)
    return out


def eval_cloud(cloud):
    """A cloud as the eval sees it: normalised, then PCA-aligned."""
    pts = normalize_points(cloud["points"])
    pts, nrm = pca_align(pts, cloud["normals"])
    return {**cloud, "points": pts.astype(np.float32),
            "normals": nrm.astype(np.float32)}


def make_pool(seed: int, count: int, n_points: int, segments,
              edges: bool = False, prepare=eval_cloud):
    """`count` clouds from one seed, with the segment counts of
    `segment_counts` in an order drawn from the seed, each passed through
    `prepare`."""
    rng = np.random.RandomState(np.random.SeedSequence(
        (seed, 1)).generate_state(1)[0])
    ks = rng.permutation(segment_counts(count, segments))
    return [prepare(make_cloud(rng, n_points, int(k), edges)) for k in ks]


def stack(clouds, keys=("points", "normals", "labels", "prim")):
    return {k: np.stack([c[k] for c in clouds]) for k in keys}


def eval_batches(seed: int, pool, batch: int):
    """Endless batches of `batch` distinct pool clouds: the pool in an
    order drawn from the seed, epoch after epoch, the rest of an epoch
    that fills no batch dropped."""
    rng = np.random.default_rng((seed, 2))
    while True:
        order = rng.permutation(len(pool))
        for s in range(0, len(order) - batch + 1, batch):
            yield stack([pool[i] for i in order[s:s + batch]])


def derived_seed(seed: int, part: int) -> int:
    """A 31-bit seed for one part of a run, from the run's seed."""
    return int(np.random.SeedSequence((seed, part)).generate_state(1)[0]
               & 0x7FFFFFFF)


class Augment:
    """The reference's train augmentation (src/augment_utils.py:177-204):
    p 0.5 a small rotation, p 0.2 a rotation about y, p 0.5 a shift of the
    points, p 0.5 a scale of the points, drawn from `rng` in that order."""

    def __init__(self, rng):
        self.rng = rng

    def _small_rotation(self):
        a = np.clip(0.2 * self.rng.randn(3), -0.5, 0.5)
        cx, sx = np.cos(a[0]), np.sin(a[0])
        cy, sy = np.cos(a[1]), np.sin(a[1])
        cz, sz = np.cos(a[2]), np.sin(a[2])
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return rz @ ry @ rx

    def __call__(self, points, normals):
        if self.rng.random_sample() > 0.5:
            r = self._small_rotation()
            points, normals = points @ r, normals @ r
        if self.rng.random_sample() > 0.8:
            t = self.rng.uniform() * 2 * np.pi
            c, s = np.cos(t), np.sin(t)
            r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            points, normals = points @ r, normals @ r
        if self.rng.random_sample() > 0.5:
            points = points + self.rng.uniform(-0.05, 0.05, (3,))
        if self.rng.random_sample() > 0.5:
            points = points * self.rng.uniform(0.8, 1.2)
        return points.astype(np.float32), normals.astype(np.float32)


def feed_batches(pool, batch: int, loader_seed: int, item_seed: int,
                 max_segments: int):
    """The train batches the feed gives for this pool and these seeds:
    per epoch one shuffle of the pool (batches of `batch`, the rest
    dropped), per cloud: centred, scaled by its largest extent, augmented,
    PCA-aligned, instance ids made canonical (clipped at max_segments - 1)
    and its points permuted."""
    order_rng = np.random.RandomState(loader_seed)
    rng = np.random.RandomState(item_seed)
    aug = Augment(rng)
    points = [c["points"] - c["points"].mean(0, keepdims=True) for c in pool]

    def item(i):
        pts = points[i].copy()
        extent = pts.max(0) - pts.min(0)
        pts = pts / (extent.max() + EPS)
        pts, nrm = aug(pts, pool[i]["normals"].copy())
        pts, nrm = pca_align(pts, nrm)
        _, inv = np.unique(pool[i]["labels"], return_inverse=True)
        out = {"points": pts.astype(np.float32),
               "normals": nrm.astype(np.float32),
               "labels": np.minimum(inv.astype(np.int32), max_segments - 1
                                    ).reshape(pool[i]["labels"].shape),
               "prim": pool[i]["prim"].astype(np.int32),
               "edges": pool[i]["edges"].astype(np.int32),
               "edges_w": pool[i]["edges_w"].astype(np.float32)}
        sel = rng.permutation(pts.shape[0])
        return {k: v[sel] for k, v in out.items()}

    while True:
        order = np.arange(len(pool))
        order_rng.shuffle(order)
        for s in range(0, len(order) - batch + 1, batch):
            items = [item(int(i)) for i in order[s:s + batch]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
