"""Sharded training over ranks on ``torch.distributed`` (counterpart of
``traffic_env_tpu/parallel/``): see ``dist.py``."""

from .dist import (all_gather, all_reduce, all_sum, broadcast_object,
                   device, distributed_init, dp_rank, dp_size, env_slice,
                   is_primary, launch, mesh_dims, rank, shard, shutdown,
                   world)

__all__ = ["all_gather", "all_reduce", "all_sum", "broadcast_object",
           "device", "distributed_init", "dp_rank", "dp_size", "env_slice",
           "is_primary", "launch", "mesh_dims", "rank", "shard", "shutdown",
           "world"]
