from ripor_tpu_torch.parallel.reference import split_sums
from ripor_tpu_torch.parallel.sharding import (
    DataSlice,
    batch_sharding,
    decode_param_partition_spec,
    decode_params_pspec_tree,
    opt_moment_spec,
    opt_state_pspec_tree,
    param_partition_spec,
    params_pspec_tree,
    shard_batch,
    shard_decode_params,
    shard_opt_state,
    shard_params,
)

__all__ = ["param_partition_spec", "shard_params", "shard_batch",
           "batch_sharding", "opt_moment_spec", "opt_state_pspec_tree",
           "shard_opt_state", "params_pspec_tree",
           "decode_param_partition_spec", "decode_params_pspec_tree",
           "shard_decode_params", "DataSlice", "split_sums"]
