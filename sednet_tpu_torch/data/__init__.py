from sednet_tpu_torch.data.augment import Augmentor
from sednet_tpu_torch.data.datasets import (BatchLoader, EdgeDataset,
                                            MixedDataset, ParseNetDataset,
                                            PrefetchLoader)
from sednet_tpu_torch.data.geometry import (normalize_points, pca_align,
                                            rotation_matrix_a_to_b)
from sednet_tpu_torch.data.labels import (canonicalize_instance_labels,
                                          project_types_fitting,
                                          remap_type_labels_eval,
                                          remap_type_labels_train)
from sednet_tpu_torch.data.synthetic import (EVAL_STREAM_SEED,
                                             make_synthetic_shape,
                                             write_edge_h5, write_parsenet_h5)

__all__ = ["Augmentor", "BatchLoader", "EVAL_STREAM_SEED", "EdgeDataset",
           "MixedDataset", "ParseNetDataset", "PrefetchLoader",
           "canonicalize_instance_labels", "make_synthetic_shape",
           "normalize_points", "pca_align", "project_types_fitting",
           "remap_type_labels_eval", "remap_type_labels_train",
           "rotation_matrix_a_to_b", "write_edge_h5", "write_parsenet_h5"]
