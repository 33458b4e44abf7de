"""Train-time point-cloud augmentation (a copy of
`sednet_tpu/data/augment.py`; the eval never augments).

Reference: src/augment_utils.py:177-204 (MyAugment) — per-shape:
  * p=0.5 small random rotation (sigma 0.2, clip 0.5 per Euler angle),
  * p=0.2 full rotation about y,
  * p=0.5 shift +-0.05 (positions only, not normals),
  * p=0.5 uniform scale [0.8, 1.2] (positions only).
Rotations apply to both points and normals; shift/scale to points only
(augment_utils.py:199-203).
"""
from __future__ import annotations

import numpy as np


class Augmentor:
    def __init__(self, rng: np.random.RandomState | None = None):
        self.rng = rng or np.random.RandomState()

    def _small_rotation(self, sigma=0.2, clip=0.5) -> np.ndarray:
        a = np.clip(sigma * self.rng.randn(3), -clip, clip)
        cx, sx = np.cos(a[0]), np.sin(a[0])
        cy, sy = np.cos(a[1]), np.sin(a[1])
        cz, sz = np.cos(a[2]), np.sin(a[2])
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return rz @ ry @ rx

    def _y_rotation(self) -> np.ndarray:
        t = self.rng.uniform() * 2 * np.pi
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def __call__(self, points: np.ndarray, normals: np.ndarray | None = None,
                 extra_positions: np.ndarray | None = None):
        """points: (N, 3); normals: optional (N, 3). extra_positions is a
        second position-like cloud (the edges1w channel) that rides the SAME
        random draws — rotated, shifted and scaled exactly like points, the
        way the reference appends it to MyAugment's position list
        (reference: src/dataset_segments_my.py:445-453). Returns augmented
        copies (extra only when given)."""
        points = points.copy()
        normals = None if normals is None else normals.copy()
        extra = None if extra_positions is None else extra_positions.copy()
        if self.rng.random_sample() > 0.5:
            r = self._small_rotation()
            points = points @ r  # reference right-multiplies (augment_utils.py:84)
            if normals is not None:
                normals = normals @ r
            if extra is not None:
                extra = extra @ r
        if self.rng.random_sample() > 0.8:
            r = self._y_rotation()
            points = points @ r
            if normals is not None:
                normals = normals @ r
            if extra is not None:
                extra = extra @ r
        if self.rng.random_sample() > 0.5:
            shift = self.rng.uniform(-0.05, 0.05, (3,))
            points = points + shift
            if extra is not None:
                extra = extra + shift
        if self.rng.random_sample() > 0.5:
            scale = self.rng.uniform(0.8, 1.2)
            points = points * scale
            if extra is not None:
                extra = extra * scale
        out_n = None if normals is None else normals.astype(np.float32)
        if extra_positions is None:
            return points.astype(np.float32), out_n
        return points.astype(np.float32), out_n, extra.astype(np.float32)


def gaussian_noise(points: np.ndarray, level: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """Isotropic jitter at the reference's noise levels
    (reference: src/dataset_segments.py:420-434)."""
    sigma = {0: 0.005, 1: 0.01, 2: 0.02, 3: 0.05}[level]
    clip = 5.0 * sigma
    return points + np.clip(sigma * rng.randn(*points.shape), -clip, clip)


def along_normal_noise(points: np.ndarray, normals: np.ndarray,
                       rng: np.random.RandomState):
    """Noise-level -1: perturb normals in-plane and shift points along them
    (reference: src/dataset_segments.py:436-447)."""
    n = normals.copy()
    w = rng.random_sample((n.shape[0], 1))
    shift = np.clip(0.087 * rng.randn(n.shape[0], 1), -3 * 0.087, 3 * 0.087)
    angle2 = np.arctan(n[:, 0] / (n[:, 1] + 1e-8))
    a1 = np.zeros_like(n)
    a1[:, 0], a1[:, 1] = np.cos(angle2), np.sin(angle2)
    a2 = np.cross(a1, n)
    n = n + (w * a1 + (1 - w) * a2) * shift
    sigma = 0.025
    pts = np.clip(sigma * 0.33 * rng.randn(points.shape[0], 1),
                  -sigma, sigma) * n + points
    return pts.astype(np.float32), n.astype(np.float32)
