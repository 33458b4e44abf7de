"""Classical clustering baselines: kmeans, spectral and sklearn's
mean-shift (a copy of `sednet_tpu/cluster/baselines.py`, reference:
src/segment_utils.py:14-37 `cluster`). For ablations only; the production
path is `cluster.mean_shift`. sklearn is imported when called, never at
import; where it is absent the call raises ImportError naming it (the
card's machine has none).
"""
from __future__ import annotations

import numpy as np

RANDOM_STATE = 170  # reference: src/segment_utils.py:6


def cluster(x: np.ndarray, number_cluster: int, bandwidth: float | None = None,
            alg: str = "kmeans") -> np.ndarray:
    try:
        from sklearn.cluster import (KMeans, MeanShift, SpectralClustering,
                                     estimate_bandwidth)
    except ImportError as exc:
        raise ImportError("cluster.baselines needs scikit-learn (sklearn), "
                          "which is not installed") from exc

    x = x.astype(np.float32)
    if alg == "kmeans":
        return KMeans(n_clusters=number_cluster,
                      random_state=RANDOM_STATE).fit_predict(x)
    if alg == "spectral":
        return SpectralClustering(n_clusters=number_cluster,
                                  random_state=RANDOM_STATE).fit_predict(x)
    if alg == "meanshift":
        if not bandwidth:
            bandwidth = estimate_bandwidth(x, quantile=0.1, n_samples=1000)
        seeds = x[np.random.choice(np.arange(x.shape[0]),
                                   min(5000, x.shape[0]))]
        return MeanShift(bandwidth=bandwidth, seeds=seeds).fit_predict(x)
    raise ValueError(f"unknown algorithm {alg}")
