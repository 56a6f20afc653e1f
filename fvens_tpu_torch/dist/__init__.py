"""Domain decomposition over torch.distributed ranks: the port of the JAX
package's dist/ (partition.py, shard.py) with its own process layer
(comm.py: halo exchange and reductions; launch.py: starting the ranks)."""

from .partition import ShardedMeshBundle, halo_schedule_stats, partition_mesh

__all__ = ["ShardedMeshBundle", "halo_schedule_stats", "partition_mesh"]
