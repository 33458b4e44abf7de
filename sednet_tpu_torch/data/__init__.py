from sednet_tpu_torch.data.geometry import normalize_points, pca_align
from sednet_tpu_torch.data.synthetic import (EVAL_STREAM_SEED,
                                             make_synthetic_shape)

__all__ = ["EVAL_STREAM_SEED", "make_synthetic_shape", "normalize_points",
           "pca_align"]
