"""The configuration fields the inference slice reads.

A copy of the relevant part of `sednet_tpu/config.py:30-82`, with the same
names and defaults, so that one set of values describes both packages. The
model reads the first group (`SEDNet.from_config`); `predict.segment_batch`
reads the `ms_*` group (`predict.cluster_settings`). The point count is
not a field: both read it from the input.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    mode: int = 5                # 0: xyz only, 5: xyz + normals
    embed: int = 128
    knn: int = 64
    num_primitives: int = 6
    normal_metric_W: float = 1.0
    w_pos_enc: float = 0.2
    edge_module: bool = True
    late_fusion: bool = True
    combine_label_prim: bool = True

    ms_quantile: float = 0.015
    ms_iterations: int = 50
    ms_num_samples: int = 10000
    ms_max_clusters: int = 50    # at most ms_max_clusters - 1 clusters
    ms_retry_factor: float = 1.2
    ms_tol: float = 1e-6
