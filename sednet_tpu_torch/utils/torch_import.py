"""The reference's `.pth` checkpoints into the port's SEDNet.

Counterpart of `sednet_tpu/utils/torch_import.py` (reference module names:
src/SEDNet.py:19-48, 216-290). The JAX package maps a reference state dict
onto flax parameter paths; the port's modules carry those flax paths as
their names (`weights.py`), so the map here goes from the reference's keys
to the port's own state dict:

  * DataParallel's `module.` prefix is stripped
    (generate_predictions_aug.py:191-198);
  * a conv weight (Cout, Cin, 1[, 1]) becomes the Linear weight
    (Cout, Cin), with no transpose (flax's kernel is its transpose);
  * a GroupNorm's weight and bias keep their names under the flax path
    (`gn`, `gn_mlp1`, ...);
  * duplicate registrations (encoder.bn1 is also encoder.conv1.1 through
    the Sequential) and reference-only entries (encoder.bn4/bn5, pos_enc)
    are dropped and logged.

`params_to_torch_state_dict` is the inverse, for writing reference-layout
files from the port's parameters.
"""
from __future__ import annotations

import logging
from typing import Any, Dict

import torch

logger = logging.getLogger("sednet_tpu_torch.torch_import")

# (reference prefix, flax path, has a bias) of the convolutions and dense
# layers; the encoder's Sequential convs have no bias (src/SEDNet.py:37-45)
_DENSE = [
    ("encoder.conv1.0", ("encoder", "conv1", "conv"), False),
    ("encoder.conv2.0", ("encoder", "conv2", "conv"), False),
    ("encoder.conv3.0", ("encoder", "conv3", "conv"), False),
    ("encoder.mlp1", ("encoder", "mlp1"), True),
    ("conv1", ("conv1",), True),
    ("conv2", ("conv2",), True),
    ("mlp_prim_prob1", ("mlp_prim_prob1",), True),
    ("mlp_prim_prob2", ("mlp_prim_prob2",), True),
    ("edge_module.0", ("edge_conv1",), True),
    ("edge_module.2", ("edge_conv2",), True),
    ("asis.0", ("asis_conv",), True),
    ("mlp_seg_prob1", ("mlp_seg_prob1",), True),
    ("mlp_seg_prob2", ("mlp_seg_prob2",), True),
    ("prim_encoding.0", ("prim_encoding",), True),
    ("normal_predict_mlps.0", ("normal_conv1",), True),
    ("normal_predict_mlps.2", ("normal_conv2",), True),
]

# (reference prefix, flax path) of the GroupNorms
_GN = [
    ("encoder.bn1", ("encoder", "conv1", "gn")),
    ("encoder.bn2", ("encoder", "conv2", "gn")),
    ("encoder.bn3", ("encoder", "conv3", "gn")),
    ("encoder.bnmlp1", ("encoder", "gn_mlp1")),
    ("bn1", ("gn1",)),
    ("bn2", ("gn2",)),
    ("bn_prim_prob1", ("gn_prim",)),
    ("bn_seg_prob1", ("gn_seg",)),
    ("edge_module.1", ("edge_gn",)),
    ("asis.1", ("asis_gn",)),
    ("normal_predict_mlps.1", ("normal_gn",)),
]


def strip_module_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel's `module.` prefix
    (reference: generate_predictions_aug.py:191-198)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().to(torch.float32)


def torch_state_dict_to_params(state_dict: Dict[str, Any],
                               strict: bool = False) -> Dict[str, Any]:
    """A reference SEDNet state dict as the port's SEDNet state dict
    (float32 CPU tensors). strict: a missing key raises KeyError; otherwise
    it is skipped, as the reference's tolerant loader does
    (train_sed_net.py:97-113)."""
    sd = strip_module_prefix(state_dict)
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(src: str, dst: str, required: bool = True):
        if src not in sd:
            if strict and required:
                raise KeyError(src)
            return False
        value = _f32(sd[src])
        if value.dim() > 2:
            value = value.reshape(value.shape[0], value.shape[1])
        out[dst] = value.contiguous()
        used.add(src)
        return True

    for prefix, path, has_bias in _DENSE:
        name = ".".join(path)
        if take(prefix + ".weight", name + ".weight") and has_bias:
            take(prefix + ".bias", name + ".bias")
    for prefix, path in _GN:
        name = ".".join(path)
        if take(prefix + ".weight", name + ".weight"):
            take(prefix + ".bias", name + ".bias")
    leftover = [k for k in sd if k not in used]
    if leftover:
        logger.warning("unmatched checkpoint keys (ignored): %s",
                       leftover[:20] + (["..."] if len(leftover) > 20
                                        else []))
    return out


def params_to_torch_state_dict(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: the port's SEDNet state dict as a reference state dict
    (CPU tensors). Conv weights get Conv1d's trailing singleton dim, the
    encoder's edge convs Conv2d's two (reference src/SEDNet.py:37-45)."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path, has_bias in _DENSE:
        name = ".".join(path)
        if name + ".weight" not in params:
            continue
        w = _f32(params[name + ".weight"])
        extra = (1, 1) if prefix.startswith("encoder.conv") else (1,)
        sd[prefix + ".weight"] = w.reshape(*w.shape, *extra).contiguous()
        if has_bias and name + ".bias" in params:
            sd[prefix + ".bias"] = _f32(params[name + ".bias"]).contiguous()
    for prefix, path in _GN:
        name = ".".join(path)
        if name + ".weight" not in params:
            continue
        sd[prefix + ".weight"] = _f32(params[name + ".weight"]).contiguous()
        sd[prefix + ".bias"] = _f32(params[name + ".bias"]).contiguous()
    return sd


def load_torch_checkpoint(path: str, strict: bool = False) -> Dict[str, Any]:
    """A reference `.pth` checkpoint as the port's SEDNet state dict. A
    plain state dict, or one under "state_dict" or "model_state"; read with
    `weights_only=True` onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model_state" in sd:
        sd = sd["model_state"]
    return torch_state_dict_to_params(sd, strict=strict)
