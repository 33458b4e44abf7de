"""Point-cloud visualization dumps (a copy of `sednet_tpu/utils/vis.py`:
`COLORS_TYPE`, `instance_palette`, `visual_labels` and `save_xyz`).

Equivalent of the reference's gen_test_vis.py:51-57 (visual_labels over a
fixed type palette) and src/VisUtils.py save_xyz. Colors here are a
deterministic generated palette rather than the reference's hand-picked
table; downstream tooling only needs stable distinct colors per label.
"""
from __future__ import annotations

import colorsys

import numpy as np


def _make_palette(n: int, seed: int = 0) -> np.ndarray:
    """Distinct, stable colors via golden-ratio hue stepping."""
    rng = np.random.RandomState(seed)
    colors = []
    h = rng.random_sample()
    for i in range(n):
        h = (h + 0.61803398875) % 1.0
        s = 0.55 + 0.4 * ((i * 7) % 3) / 2.0
        v = 0.65 + 0.3 * ((i * 5) % 2)
        colors.append([c * 255 for c in colorsys.hsv_to_rgb(h, min(s, 1.0),
                                                            min(v, 1.0))])
    return np.asarray(colors, np.float32)


#: palette indexed by type/instance label (64 entries like the reference's)
COLORS_TYPE = _make_palette(64)


def instance_palette(n: int) -> np.ndarray:
    """Viridis-like ramp for instance ids (reference: gen_test_vis.py:68)."""
    t = np.linspace(0.0, 1.0, max(n, 2))
    r = np.clip(1.5 * t - 0.25, 0, 1)
    g = np.clip(1.2 * t + 0.1, 0, 1)
    b = np.clip(1.0 - 1.2 * t + 0.3, 0, 1)
    return (np.stack([r, g, b], 1) * 255).astype(np.float32)


def visual_labels(points: np.ndarray, labels: np.ndarray,
                  palette: np.ndarray | None = None) -> np.ndarray:
    """(N,3) points + (N,) labels -> (N,6) [xyz rgb]
    (reference: gen_test_vis.py:51-57)."""
    palette = COLORS_TYPE if palette is None else palette
    out = np.zeros((points.shape[0], 6))
    out[:, :3] = points[:, :3]
    out[:, 3:] = palette[np.clip(labels.astype(np.int64), 0,
                                 len(palette) - 1)]
    return out


def save_xyz(path: str, points: np.ndarray) -> None:
    np.savetxt(path, points, fmt="%0.6f", delimiter=" ")
