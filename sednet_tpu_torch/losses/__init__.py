from sednet_tpu_torch.losses.edge import (edge_cls_loss, edge_embedding_loss,
                                          pull_push_embedding_loss)
from sednet_tpu_torch.losses.embedding import TripletConfig, triplet_loss
from sednet_tpu_torch.losses.type_loss import (evaluate_type_miou,
                                               label_smoothing_nll,
                                               primitive_nll)

__all__ = ["TripletConfig", "edge_cls_loss", "edge_embedding_loss",
           "evaluate_type_miou", "label_smoothing_nll", "primitive_nll",
           "pull_push_embedding_loss", "triplet_loss"]
