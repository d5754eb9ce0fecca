from maskflownet_torch.parallel.mesh import (DevicePrefetcher, Mesh,
                                             all_reduce_mean, batch_sharding,
                                             initialize_distributed,
                                             make_mesh, replicated_sharding,
                                             shard_batch,
                                             shutdown_distributed)
from maskflownet_torch.parallel.spatial import (make_spatial_forward,
                                                make_spatial_mesh)

__all__ = ["DevicePrefetcher", "Mesh", "all_reduce_mean", "batch_sharding",
           "initialize_distributed", "make_mesh", "make_spatial_forward",
           "make_spatial_mesh", "replicated_sharding", "shard_batch",
           "shutdown_distributed"]
