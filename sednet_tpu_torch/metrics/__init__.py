from sednet_tpu_torch.metrics.segmentation import (
    batch_iou, compute_type_miou_abc, hungarian_match, mean_iou_one_sample,
    relaxed_iou_fast, siou_matched_segments, siou_matched_segments_usecd,
    siou_matched_segments_usecd_batch, to_one_hot)

__all__ = ["batch_iou", "compute_type_miou_abc", "hungarian_match",
           "mean_iou_one_sample", "relaxed_iou_fast",
           "siou_matched_segments", "siou_matched_segments_usecd",
           "siou_matched_segments_usecd_batch", "to_one_hot"]
