from sednet_tpu_torch.cluster.mean_shift import (DEFAULT_MS_TOL,
                                                 MeanShiftResult,
                                                 cluster_batch,
                                                 compute_bandwidth,
                                                 guard_mean_shift, mean_shift,
                                                 mean_shift_iterate, nms)

__all__ = ["DEFAULT_MS_TOL", "MeanShiftResult", "cluster_batch",
           "compute_bandwidth", "guard_mean_shift", "mean_shift",
           "mean_shift_iterate", "nms"]
