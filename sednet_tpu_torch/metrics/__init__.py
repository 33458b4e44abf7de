from sednet_tpu_torch.metrics.segmentation import (batch_iou,
                                                   siou_matched_segments,
                                                   to_one_hot)

__all__ = ["batch_iou", "siou_matched_segments", "to_one_hot"]
