"""The packed forward over a (data, model) mesh driven from one process:
shard plans, placement and the sharded forward (``sharding``), and its
in-process verifier (``verify_sharded``)."""
from repro_torch.distributed.sharding import (DATA_AXES, Placed,
                                              ShardedForward,
                                              bcnn_shard_plan,
                                              bmlp_shard_plan,
                                              make_sharded_forward,
                                              packed_param_specs,
                                              packed_stage_shards,
                                              reshard_packed, shard_bcnn,
                                              shard_bmlp, shard_packed)

__all__ = ["DATA_AXES", "Placed", "ShardedForward", "bcnn_shard_plan",
           "bmlp_shard_plan", "make_sharded_forward", "packed_param_specs",
           "packed_stage_shards", "reshard_packed", "shard_bcnn",
           "shard_bmlp", "shard_packed"]
