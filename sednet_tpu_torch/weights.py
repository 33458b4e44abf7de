"""Carry the JAX package's flat `.npz` checkpoints into the PyTorch models.

`sednet_tpu/train.py:248-262` (`save_params_npz`) writes one array per leaf
under an "a/b/c" key, with a top-level prefix per model ("inst/", "type/").
The torch modules keep the flax names, so the map is by name:

  a/b/kernel (C_in, C_out)  ->  a.b.weight (C_out, C_in)   (transposed)
  a/b/bias                  ->  a.b.bias
  a/b/scale  (GroupNorm)    ->  a.b.weight

which also covers the encoder's edge convolutions
(`encoder/convN/conv/kernel` -> `encoder.convN.conv.weight`, no bias).
"""
from __future__ import annotations

import numpy as np
import torch

from sednet_tpu_torch.config import Config
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.models.sednet import SEDNet

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def params_from_flat(flat, prefix: str = "inst") -> dict:
    """Map the `prefix/...` arrays of a flat checkpoint to a torch
    state dict. Raises on a leaf it does not know or an empty prefix."""
    sd = {}
    head = prefix + "/"
    for key in flat:
        if not key.startswith(head):
            continue
        *path, leaf = key[len(head):].split("/")
        if leaf not in _LEAF:
            raise KeyError(f"unmapped checkpoint leaf {key!r}")
        arr = np.asarray(flat[key], np.float32)
        if leaf == "kernel":
            arr = arr.T
        sd[".".join(path + [_LEAF[leaf]])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    if not sd:
        raise KeyError(f"no keys under {head!r}")
    return sd


def load_npz(path: str, which: str = "inst", cfg: Config | None = None,
             device=None) -> SEDNet:
    """Build a SEDNet from `cfg` and load model `which` of the flat npz at
    `path` into it. Every key of the model and of the checkpoint's
    `which/` part must match (strict load: a missing or extra key, or a
    shape that differs, raises)."""
    dev = resolve_device(device)
    model = SEDNet.from_config(cfg or Config())
    with np.load(path) as flat:
        model.load_state_dict(params_from_flat(flat, which), strict=True)
    return model.to(dev).eval()
