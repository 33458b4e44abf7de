from sednet_tpu_torch.cluster.mean_shift import (DEFAULT_MS_TOL,
                                                 MeanShiftResult,
                                                 cluster_batch,
                                                 cluster_batch_async,
                                                 cluster_batch_finalize,
                                                 compute_bandwidth,
                                                 guard_mean_shift, mean_shift,
                                                 mean_shift_iterate, nms)

__all__ = ["DEFAULT_MS_TOL", "MeanShiftResult", "cluster_batch",
           "cluster_batch_async", "cluster_batch_finalize",
           "compute_bandwidth", "guard_mean_shift", "mean_shift",
           "mean_shift_iterate", "nms"]
