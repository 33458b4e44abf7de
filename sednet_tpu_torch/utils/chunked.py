"""Host-side blocked pairwise squared distances (a copy of
`sednet_tpu/utils/chunked.py`).

One shared qq - 2 q p^T + pp implementation (float32, row-blocked so the
full (N, M) matrix never materializes) for the numpy post-processing /
fitting paths — previously re-implemented with drifting chunk sizes and
dtypes at four sites (fit/driver.py x2, postproc/boundary.py x2)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def chunked_sqdist_blocks(q: np.ndarray, p: np.ndarray, block: int = 2048
                          ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (lo, hi, d2[lo:hi]) blocks of squared distances between rows
    of q (N, D) and p (M, D)."""
    q = np.asarray(q, np.float32)
    p = np.asarray(p, np.float32)
    pp = (p * p).sum(1)
    for lo in range(0, q.shape[0], block):
        hi = min(lo + block, q.shape[0])
        qq = (q[lo:hi] * q[lo:hi]).sum(1)
        yield lo, hi, qq[:, None] - 2.0 * (q[lo:hi] @ p.T) + pp[None, :]
