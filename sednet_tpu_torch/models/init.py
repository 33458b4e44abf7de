"""flax's default initialisation for the port's models.

torch's `nn.Linear` draws its weights and biases from a uniform of bound
1/sqrt(fan_in); the JAX package trains from flax's defaults
(`sednet_tpu/train.py:230 model.init`): Dense kernels `lecun_normal`, a
normal truncated to two standard deviations scaled to variance 1/fan_in;
biases zero; GroupNorm and BatchNorm scale one and bias zero, BatchNorm's
running mean zero and variance one. `init_like_flax` draws the same
distributions from an explicit generator. The draws are not flax's
(another generator); the tests hold the statistics.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from sednet_tpu_torch.models.backbone import GroupNorm
from sednet_tpu_torch.models.splinenet import BatchNorm

# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's constant)
_TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator):
    """Unit normal truncated to [-2, 2], by inverting its CDF at uniforms
    from `generator` (on the generator's device)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    x = math.sqrt(2.0) * torch.special.erfinv(lo + u * (hi - lo))
    return x.clamp(-2.0, 2.0).float()


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every Linear, GroupNorm and BatchNorm of `model` in
    place as flax initialises Dense, GroupNorm and BatchNorm, in the order
    of `model.modules()`; returns the model."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            fan_in = mod.weight.shape[1]
            w = truncated_normal(tuple(mod.weight.shape), generator)
            mod.weight.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (GroupNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.mean.zero_()
                mod.var.fill_(1.0)
    return model
