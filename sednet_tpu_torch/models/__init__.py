from sednet_tpu_torch.models.backbone import DGCNNEncoder, EdgeConv
from sednet_tpu_torch.models.sednet import SEDNet, SEDNetOutput, apply_fused
from sednet_tpu_torch.models.splinenet import SplineNet

__all__ = ["DGCNNEncoder", "EdgeConv", "SEDNet", "SEDNetOutput",
           "SplineNet", "apply_fused"]
