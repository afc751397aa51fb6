"""Sharded training over ranks on ``torch.distributed`` (counterpart of
``traffic_env_tpu/parallel/``): the rank layout and its collectives in
``dist.py``, the mp split of the dense layers (``shard_params``) in
``mp.py``."""

from .dist import (all_gather, all_gather_object, all_reduce, all_sum,
                   broadcast_object, device, distributed_init, dp_rank,
                   dp_size, env_slice, is_primary, launch, mesh_dims,
                   mp_all_gather, mp_all_reduce, mp_rank, mp_size, rank,
                   shard, shutdown, world)
from .mp import (full_optimizer_state, full_state_dict, global_norm,
                 load_optimizer_state, shard_params)

__all__ = ["all_gather", "all_gather_object", "all_reduce", "all_sum",
           "broadcast_object", "device", "distributed_init", "dp_rank",
           "dp_size", "env_slice", "full_optimizer_state", "full_state_dict",
           "global_norm", "is_primary", "launch", "load_optimizer_state",
           "mesh_dims", "mp_all_gather", "mp_all_reduce", "mp_rank",
           "mp_size", "rank", "shard", "shard_params", "shutdown", "world"]
