"""Carry the JAX package's flat `.npz` checkpoints into the PyTorch models.

`sednet_tpu/train.py:248-262` (`save_params_npz`) writes one array per leaf
under an "a/b/c" key: with a top-level prefix per model ("inst/", "type/")
in a two-model checkpoint such as `checkpoints/bench_10k.npz`, under
"params/" when it saved a flax variable dict, with no prefix when it saved
one model's parameters. The torch modules keep the flax names, so the map
is by name:

  a/b/kernel (C_in, C_out)  ->  a.b.weight (C_out, C_in)   (transposed)
  a/b/bias                  ->  a.b.bias
  a/b/scale  (GroupNorm)    ->  a.b.weight

which also covers the encoder's edge convolutions
(`encoder/convN/conv/kernel` -> `encoder.convN.conv.weight`, no bias), and
BatchNorm's running statistics (`a/b/mean`, `a/b/var` -> the buffers
`a.b.mean`, `a.b.var`; SplineNet's "batch_stats/" part).
`flat_from_params` and `save_params_npz` are the way back: the trainer's
checkpoints are flat `.npz` files that JAX's `load_params` reads.
"""
from __future__ import annotations

import numpy as np
import torch

from sednet_tpu_torch.config import Config
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.models.sednet import SEDNet
from sednet_tpu_torch.models.splinenet import SplineNet

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "mean", "var": "var"}


def params_from_flat(flat, prefix: str = "inst") -> dict:
    """Map the `prefix/...` arrays of a flat checkpoint (every array when
    prefix is "") to a torch state dict. Raises on a leaf it does not know
    or when no key lies under the prefix."""
    sd = {}
    head = prefix + "/" if prefix else ""
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


def flat_from_params(state_dict) -> dict:
    """The inverse of `params_from_flat(flat, "")`: a torch state dict to
    the flat "a/b/c" arrays of one model (`a.b.weight` of a Linear
    transposed back to `a/b/kernel`, a GroupNorm's 1-D `weight` back to
    `a/b/scale`)."""
    flat = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf = "kernel" if arr.ndim == 2 else "scale"
            if arr.ndim == 2:
                arr = arr.T
        elif leaf != "bias":
            raise KeyError(f"unmapped state-dict key {key!r}")
        flat["/".join(path + [leaf])] = np.ascontiguousarray(arr)
    return flat


def save_params_npz(path: str, model) -> None:
    """Write a model's parameters as one flat `.npz` in the format of
    `sednet_tpu/train.py:248 save_params_npz` (no prefix), which JAX's
    `load_params` and the port's `load_checkpoint` read."""
    np.savez_compressed(path, **flat_from_params(model.state_dict()))


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


def load_params(path: str) -> dict:
    """One model's parameters from a flat `.npz`, with or without the
    "params/" prefix, as a torch state dict: what `sednet_tpu/train.py:265
    load_params` reads from such a file, less `run_prediction`'s unwrap of
    "params". Orbax directories and the reference's `.pth` files are not
    read yet (ROADMAP queue 1 item 10)."""
    if not path.endswith(".npz"):
        kind = ("reference .pth" if path.endswith((".pth", ".pt"))
                else "orbax directory")
        raise NotImplementedError(
            f"{path!r}: the port reads flat .npz checkpoints only; the "
            f"{kind} import is ROADMAP queue 1 item 10")
    with np.load(path) as flat:
        prefix = "params" if any(k.startswith("params/")
                                 for k in flat.files) else ""
        return params_from_flat(flat, prefix)


def load_checkpoint(path: str, cfg: Config | None = None,
                    device=None) -> SEDNet:
    """A SEDNet from `cfg` with the parameters of the one-model checkpoint
    at `path` (`load_params`; strict: every key and shape must match)."""
    dev = resolve_device(device)
    model = SEDNet.from_config(cfg or Config())
    model.load_state_dict(load_params(path), strict=True)
    return model.to(dev).eval()


def splinenet_from_variables(flat, grid_size: int = 20, k: int = 10,
                             device=None) -> SplineNet:
    """A SplineNet holding JAX SplineNet variables: flat has the
    "params/..." and "batch_stats/..." arrays of the flax variable dict, as
    `sednet_tpu/train.py:248 save_params_npz` flattens it (a dict or an
    opened `.npz`). Strict: every parameter and running statistic of the
    model must be there, with its shape. In eval mode."""
    dev = resolve_device(device)
    model = SplineNet(grid_size=grid_size, k=k)
    sd = params_from_flat(flat, "params")
    sd.update(params_from_flat(flat, "batch_stats"))
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()
