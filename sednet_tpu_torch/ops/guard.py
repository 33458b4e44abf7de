"""Numerical guards (reference: src/guard.py:7-14; `sednet_tpu/ops/guard.py`)."""
import torch


def guard_exp(x, max_value: float = 75.0, min_value: float = -75.0):
    return torch.exp(torch.clamp(x, min_value, max_value))


def guard_sqrt(x, minimum: float = 1e-5):
    return torch.sqrt(torch.clamp(x, min=minimum))
