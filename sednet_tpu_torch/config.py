"""Experiment configuration.

A copy of `sednet_tpu/config.py`: the same fields, names and defaults, and
the same `load_config` for the reference's INI-ish `.yml` files and for the
JSON that `Config.save` writes, so that one config file describes both
packages. The model reads the model group (`SEDNet.from_config`);
`predict.segment_batch` and `predict.predict_shapes` read the `ms_*` group
(`predict.cluster_settings`) and the inputs, HPNet and `fused_encoder`
groups; `predict.run_prediction` reads the bookkeeping group (`dataset`,
the two checkpoint paths, `num_test`, `seed`); `train.train` reads the
optimisation, loss, preload and `mesh_shape` fields.
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
    # bookkeeping
    comment: str = ""
    model_path: str = "SEDNet_{}_lr_{}_mode_{}_k{}"
    dataset: str = ""            # "my": the SED-Net edge set, else ParseNet
    preload_model: bool = False
    pretrain_model_path: str = ""        # feeds the TYPE model at predict
    pretrain_model_type_path: str = ""   # feeds the INST model at predict
    pretrain_opti_path: str = ""

    # inputs
    normals: bool = True         # xyz ++ normals (first graph: points_normals)
    num_points: int = 10000
    num_train: int = 16000
    num_val: int = 2700
    num_test: int = 2700

    # model
    mode: int = 5                # 0: xyz only, 5: xyz + normals
    embed: int = 128
    knn: int = 64
    num_primitives: int = 6
    grid_size: int = 20
    normal_metric_W: float = 1.0
    w_pos_enc: float = 0.2
    edge_module: bool = True
    late_fusion: bool = True
    combine_label_prim: bool = True
    predict_normal: bool = False

    # optimisation
    batch_size: int = 4
    lr: float = 1e-4
    optim: str = "adamW"         # "adam" | "adamW"
    sche: str = "reduce"         # "cos" | "reduce"
    lr_sch: bool = True
    patience: int = 5
    weight_decay: float = 0.002
    epochs: int = 200
    smooth: float = 0.025
    loss_weight: float = 100.0
    input_drop: float = 0.0
    eval_T: int = 2000
    seed: int = 0

    # losses
    w_edge_embed_loss: float = 0.25
    triplet_margin: float = 1.0
    pull_margin: float = 0.5
    push_margin: float = 1.5
    edge_topk: int = 2000

    # clustering
    ms_quantile: float = 0.015
    ms_iterations: int = 50
    ms_num_samples: int = 10000
    ms_max_clusters: int = 50    # at most ms_max_clusters - 1 clusters
    ms_retry_factor: float = 1.2
    ms_tol: float = 1e-6         # shift loop's early exit; 0 runs every step
    ms_bf16: bool = False
    model_bf16: bool = False
    warmup_steps: int = 0
    grad_clip: float = 0.0

    # HPNet spectral enrichment of the clustering embedding
    hpnet_embed: bool = True
    normal_smooth_w: float = 0.5
    spectral_sigma: float = 0.1
    spectral_knn: int = 50
    spectral_eigvecs: int = 12
    # None = auto: dense affinity up to spectral_dense_max_n points,
    # matrix-free beyond
    spectral_matfree: Optional[bool] = None
    spectral_dense_max_n: int = 16384
    factored_gn: bool = True
    # index-free fused edge-conv encoder for inference (kernel K4)
    fused_encoder: bool = False

    # runtime
    gpu: str = ""
    mesh_shape: Optional[int] = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.asdict(), f, indent=2)


_BOOL = {"true": True, "false": False, "1": True, "0": False}
# reference key -> this Config's key (reference: read_config.py:52,72)
_ALIASES = {"num_epochs": "epochs", "encoder_drop": "input_drop"}


def _coerce(value: str, target_type):
    value = value.strip().strip('"').strip("'")
    if target_type is bool:
        return _BOOL[value.lower()]
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type == Optional[int]:
        return None if value.lower() in ("none", "") else int(value)
    if target_type == Optional[bool]:
        return (None if value.lower() in ("none", "")
                else _BOOL[value.lower()])
    return value


def load_config(path: str) -> Config:
    """Load a Config from an INI-ish yml file (the reference's format) or
    from the JSON that `Config.save` writes. Unknown keys are skipped."""
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
        if not m:
            continue
        key = _ALIASES.get(m.group(1), m.group(1))
        if key in known:
            kwargs[key] = _coerce(m.group(2), hints[key])
    return Config(**kwargs)
