"""The configuration fields the inference path reads.

A copy of the relevant part of `sednet_tpu/config.py:29-125,161-188`, with
the same names and defaults, so that one set of values (and one config
file) describes both packages. The model reads the model group
(`SEDNet.from_config`); `predict.segment_batch` and `predict.predict_shapes`
read the `ms_*` group (`predict.cluster_settings`); `predict_shapes` also
reads the inputs, HPNet and `fused_encoder` groups.
"""
from __future__ import annotations

import dataclasses
import json
import re
import typing
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # inputs
    normals: bool = True         # xyz ++ normals (first graph: points_normals)
    num_points: int = 10000
    seed: int = 0

    # model
    mode: int = 5                # 0: xyz only, 5: xyz + normals
    embed: int = 128
    knn: int = 64
    num_primitives: int = 6
    normal_metric_W: float = 1.0
    w_pos_enc: float = 0.2
    edge_module: bool = True
    late_fusion: bool = True
    combine_label_prim: bool = True

    # clustering
    ms_quantile: float = 0.015
    ms_iterations: int = 50
    ms_num_samples: int = 10000
    ms_max_clusters: int = 50    # at most ms_max_clusters - 1 clusters
    ms_retry_factor: float = 1.2
    ms_tol: float = 1e-6

    # HPNet spectral enrichment of the clustering embedding
    hpnet_embed: bool = True
    normal_smooth_w: float = 0.5
    spectral_sigma: float = 0.1
    spectral_knn: int = 50
    spectral_eigvecs: int = 12
    # None = auto: dense affinity up to spectral_dense_max_n points,
    # matrix-free beyond (the matrix-free path is not ported yet)
    spectral_matfree: Optional[bool] = None
    spectral_dense_max_n: int = 16384

    # index-free fused edge-conv encoder for inference (kernel K4)
    fused_encoder: bool = False


_BOOL = {"true": True, "false": False, "1": True, "0": False}


def _coerce(value: str, target_type):
    value = value.strip().strip('"').strip("'")
    if target_type is bool:
        return _BOOL[value.lower()]
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type == Optional[bool]:
        return (None if value.lower() in ("none", "")
                else _BOOL[value.lower()])
    return value


def load_config(path: str) -> Config:
    """Load a Config from an INI-ish yml file (the reference's format) or a
    JSON file. Keys this Config does not have are skipped, so the JAX
    package's config files load as they are."""
    with open(path) as f:
        text = f.read()
    known = {f.name for f in dataclasses.fields(Config)}
    if path.endswith(".json"):
        data = json.loads(text)
        return Config(**{k: v for k, v in data.items() if k in known})

    hints = typing.get_type_hints(Config)
    kwargs = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("["):
            continue
        m = re.match(r"^(\w+)\s*=\s*(.*)$", line)
        if m and m.group(1) in known:
            kwargs[m.group(1)] = _coerce(m.group(2), hints[m.group(1)])
    return Config(**kwargs)
