from ripor_tpu_torch.parallel.reference import split_sums
from ripor_tpu_torch.parallel.sharding import (
    batch_sharding,
    decode_param_partition_spec,
    decode_params_pspec_tree,
    param_partition_spec,
    params_pspec_tree,
    shard_batch,
    shard_decode_params,
)

__all__ = ["param_partition_spec", "params_pspec_tree",
           "decode_param_partition_spec", "decode_params_pspec_tree",
           "shard_decode_params", "shard_batch", "batch_sharding",
           "split_sums"]
