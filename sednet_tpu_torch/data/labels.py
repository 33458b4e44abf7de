"""Label canonicalization and the reference's type-label remaps (a copy of
`sednet_tpu/data/labels.py`).

The framework requires instance labels to be contiguous ints in
[0, max_segments) so the losses/metrics can run with static shapes; the
reference instead calls np.unique at every use site.

Type remaps (the reference uses three):
  * train remap {9,6,7}->0, 8->2 (reference: train_sed_net.py:254-255)
  * eval remap {0,6,7}->9, 8->2 (reference: src/segment_utils.py:156-164)
  * fitting-stage project_types (reference:
    Fitting_patches_and_edges/primitive_forward_v2.py:1062-1071)
"""
from __future__ import annotations

import numpy as np


def canonicalize_instance_labels(labels: np.ndarray,
                                 max_segments: int = 50) -> np.ndarray:
    """Remap arbitrary per-shape instance ids to 0..n-1 (clipped)."""
    _, inv = np.unique(labels, return_inverse=True)
    return np.minimum(inv.astype(np.int32), max_segments - 1).reshape(labels.shape)


def remap_type_labels_train(prim: np.ndarray) -> np.ndarray:
    """{9: closed bspline, 6: revolution, 7: extrusion} -> 0 (other/closed),
    8 (torus-like) -> 2 (open bspline). Reference: train_sed_net.py:254-255."""
    out = prim.copy()
    out[(out == 9) | (out == 6) | (out == 7)] = 0
    out[out == 8] = 2
    return out


def remap_type_labels_eval(prim: np.ndarray) -> np.ndarray:
    """{0, 6, 7} -> 9, 8 -> 2. Reference: src/segment_utils.py:156-164."""
    out = prim.copy()
    out[(out == 0) | (out == 6) | (out == 7)] = 9
    out[out == 8] = 2
    return out


def project_types_fitting(prim: np.ndarray) -> np.ndarray:
    """Fitting-stage compaction: closed-spline/other {0,9,6,7}->0, plane 1->1,
    open-spline {2,8}->5, cone 3->3, cylinder 4->2, sphere 5->4.
    Reference: Fitting_patches_and_edges/primitive_forward_v2.py:1062-1071."""
    out = np.zeros_like(prim)
    out[prim == 1] = 1   # plane
    out[prim == 4] = 2   # cylinder
    out[prim == 3] = 3   # cone
    out[prim == 5] = 4   # sphere
    out[(prim == 2) | (prim == 8)] = 5  # open bspline
    return out
