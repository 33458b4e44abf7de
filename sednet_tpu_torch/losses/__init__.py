from sednet_tpu_torch.losses.edge import (edge_cls_loss, edge_embedding_loss,
                                          pull_push_embedding_loss)
from sednet_tpu_torch.losses.embedding import TripletConfig, triplet_loss
from sednet_tpu_torch.losses.iou_loss import (miou_loss, miou_loss_edge,
                                              miou_loss_weighted,
                                              reorder_pred_idx)
from sednet_tpu_torch.losses.spline import (
    control_points_permute_closed_loss, control_points_permute_loss,
    laplacian_loss, spline_reconstruction_loss,
    spline_reconstruction_loss_one_sided)
from sednet_tpu_torch.losses.type_loss import (evaluate_type_miou,
                                               label_smoothing_nll,
                                               primitive_nll)

__all__ = ["TripletConfig", "control_points_permute_closed_loss",
           "control_points_permute_loss", "edge_cls_loss",
           "edge_embedding_loss", "evaluate_type_miou", "label_smoothing_nll",
           "laplacian_loss", "miou_loss", "miou_loss_edge",
           "miou_loss_weighted", "primitive_nll", "pull_push_embedding_loss",
           "spline_reconstruction_loss",
           "reorder_pred_idx", "spline_reconstruction_loss_one_sided",
           "triplet_loss"]
