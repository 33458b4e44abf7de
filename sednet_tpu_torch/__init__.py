"""PyTorch/CUDA port of the SED-Net inference path for an NVIDIA H100.

Layout is channels-last (B, N, C), like the JAX package `sednet_tpu`,
which stays the reference. This package imports neither JAX nor
`sednet_tpu`.

The JAX reference runs its distance matmuls at Precision.HIGHEST, so
TF32 is switched off here for matmuls and convolutions alike: neighbour
sets and mean-shift kernels are sensitive to the ~1e-3 rounding TF32 adds.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from sednet_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
