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
`parsenet_from_params` loads the same names into the legacy
`ParseNetEmbedding`. `flat_from_params` and `save_params_npz` are the way back: the trainer's
checkpoints are flat `.npz` files that JAX's `load_params` reads.

`load_params` also reads the two other formats of `sednet_tpu/train.py:265
load_params`: the reference's `.pth` files (`utils/torch_import.py`) and
orbax directories, which every shipped config names. An orbax directory is
read without JAX or orbax (`read_orbax_tree`: its JSON metadata and
tensorstore); tensorstore is imported only then, and its absence raises.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from sednet_tpu_torch.config import Config
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.models.parsenet import ParseNetEmbedding
from sednet_tpu_torch.models.sednet import SEDNet
from sednet_tpu_torch.models.splinenet import SplineNet
from sednet_tpu_torch.utils.torch_import import load_torch_checkpoint

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
        arr = np.array(flat[key], np.float32)   # a writable copy
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


def read_orbax_tree(path: str) -> dict:
    """An orbax checkpoint directory (`ocp.PyTreeCheckpointer().save`) as a
    nested dict of numpy arrays, read without JAX or orbax: `_METADATA`
    (JSON) lists each leaf's key path, and tensorstore reads the leaf from
    the directory's OCDBT store of zarr (v2) arrays, the layout orbax
    writes by default. Sequence keys (a tuple's positions, as in an optax
    state) become the strings "0", "1", ...; empty nodes (an optax
    EmptyState, an empty dict) become empty dicts. Raises ImportError when
    tensorstore is absent, ValueError on another layout."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"{path!r}: reading an orbax checkpoint directory "
                          "needs the tensorstore package") from e
    root = os.path.abspath(path)
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{path!r}: an orbax layout without OCDBT or with "
                         "zarr3 is not read (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')})")
    tree: dict = {}
    for key, leaf in meta["tree_metadata"].items():
        keys = [k["key"] for k in leaf["key_metadata"]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if leaf["value_metadata"].get("skip_deserialize"):
            node.setdefault(keys[-1], {})
            continue
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": "file://" + root,
            "path": ".".join(keys)}}).result()
        node[keys[-1]] = np.asarray(store.read().result())
    return tree


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict as flat "a/b/c" arrays (the keys of
    `sednet_tpu/train.py:248 save_params_npz`)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
    return flat


def load_params(path: str) -> dict:
    """One model's parameters as a torch state dict, from any of the three
    formats of `sednet_tpu/train.py:265 load_params`: a reference `.pth` /
    `.pt` (`utils.torch_import`), a flat `.npz`, or an orbax directory
    (`read_orbax_tree`). A tree under a lone "params" key is unwrapped, as
    `run_prediction` and `load_params_tolerant` unwrap it
    (`sednet_tpu/train.py:292-293`)."""
    if path.endswith((".pth", ".pt")):
        return load_torch_checkpoint(path)
    if path.endswith(".npz"):
        with np.load(path) as flat:
            prefix = "params" if any(k.startswith("params/")
                                     for k in flat.files) else ""
            return params_from_flat(flat, prefix)
    tree = read_orbax_tree(path)
    if set(tree) == {"params"}:
        tree = tree["params"]
    return params_from_flat(flatten_tree(tree), "")


def load_checkpoint(path: str, cfg: Config | None = None,
                    device=None) -> SEDNet:
    """A SEDNet from `cfg` with the parameters of the one-model checkpoint
    at `path` (`load_params`; strict: every key and shape must match)."""
    dev = resolve_device(device)
    model = SEDNet.from_config(cfg or Config())
    model.load_state_dict(load_params(path), strict=True)
    return model.to(dev).eval()


def parsenet_from_params(flat, prefix: str = "", device=None,
                         **model_kw) -> ParseNetEmbedding:
    """A ParseNetEmbedding (built with model_kw) holding the JAX model's
    parameters: flat has the "a/b/c" arrays of its flax parameter tree
    under `prefix` (a dict or an opened `.npz`; "" for every array), as
    `sednet_tpu/train.py:248 save_params_npz` flattens it. Strict: every
    parameter of the model must be there, with its shape. In eval mode."""
    dev = resolve_device(device)
    model = ParseNetEmbedding(**model_kw)
    model.load_state_dict(params_from_flat(flat, prefix), strict=True)
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


def flat_from_splinenet(model: SplineNet) -> dict:
    """The inverse of `splinenet_from_variables`: the model's variables as
    the flat arrays of a flax variable dict, "params/..." (kernels
    transposed, BatchNorm weights as `scale`) and
    "batch_stats/.../mean|var"."""
    sd = model.state_dict()
    stats = {k for k in sd if k.endswith((".mean", ".var"))}
    flat = {"params/" + k: v for k, v in flat_from_params(
        {k: v for k, v in sd.items() if k not in stats}).items()}
    for k in stats:
        flat["batch_stats/" + k.replace(".", "/")] = \
            sd[k].detach().cpu().numpy().astype(np.float32)
    return flat
