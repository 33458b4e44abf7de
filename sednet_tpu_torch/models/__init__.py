from sednet_tpu_torch.models.backbone import DGCNNEncoder, EdgeConv
from sednet_tpu_torch.models.sednet import SEDNet, SEDNetOutput, apply_fused

__all__ = ["DGCNNEncoder", "EdgeConv", "SEDNet", "SEDNetOutput",
           "apply_fused"]
