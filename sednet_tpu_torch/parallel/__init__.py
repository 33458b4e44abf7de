"""Multi-device execution over `torch.distributed` process groups (the
counterpart of `sednet_tpu/parallel/`): data parallelism for training and
prediction, and one cloud's point axis sharded over the ranks."""
from sednet_tpu_torch.parallel.mesh import (Mesh, init_mesh, make_mesh,
                                            replicate, shard_batch, spawn)
from sednet_tpu_torch.parallel.intra_shape import (mean_shift_iterate_sharded,
                                                   ring_knn)
from sednet_tpu_torch.parallel.big_forward import (big_cloud_segment,
                                                   big_sednet_forward)

__all__ = ["Mesh", "init_mesh", "make_mesh", "replicate", "shard_batch",
           "spawn", "ring_knn", "mean_shift_iterate_sharded",
           "big_sednet_forward", "big_cloud_segment"]
