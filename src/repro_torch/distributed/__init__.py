"""Sharding over a (pod, data, model) mesh driven from one process: the
sharding rules, placement and the packed sharded forward (``sharding``),
the sharded train step's counted gathers and reductions and their
reckoning from shapes (``fsdp``), and the packed forward's in-process
verifier (``verify_sharded``)."""
from repro_torch.distributed.sharding import (DATA_AXES, HBM_BYTES, Placed,
                                              ShardedForward, Shardings,
                                              batch_specs, bcnn_shard_plan,
                                              bmlp_shard_plan, cache_specs,
                                              data_positions, drop_fsdp,
                                              logical_activation_spec,
                                              make_sharded_forward,
                                              packed_param_specs,
                                              packed_stage_shards,
                                              param_specs, position_bytes,
                                              reshard_packed,
                                              shard_bcnn, shard_bmlp,
                                              shard_packed, should_fsdp,
                                              unshard)

__all__ = ["DATA_AXES", "HBM_BYTES", "Placed", "ShardedForward",
           "Shardings", "batch_specs", "bcnn_shard_plan", "bmlp_shard_plan",
           "cache_specs", "data_positions", "drop_fsdp",
           "logical_activation_spec", "make_sharded_forward",
           "packed_param_specs", "packed_stage_shards", "param_specs",
           "position_bytes", "reshard_packed", "shard_bcnn",
           "shard_bmlp", "shard_packed", "should_fsdp", "unshard"]
