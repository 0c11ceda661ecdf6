"""Parameter / batch sharding rules over the ('data', 'model') mesh.

Port of ripor_tpu/parallel/sharding.py's spec rules and batch helpers, on
the port's flat state_dict names. Tensor parallelism shards attention
heads and d_ff over the 'model' axis megatron-style, the token-embedding
vocab dim likewise for training; codebooks, norms and (outside decode)
the relative-position tables replicate.

A spec is a tuple with one mesh axis name (or None) per tensor dimension,
the JAX ``PartitionSpec``; () is replicated. The port's ``Linear.weight``
is [out, in] where flax's ``kernel`` is [in, out] (models/convert.py
transposes it), so the split dimension flips against the JAX package's:
the column-parallel q, k, v, wi, wi_0, wi_1 split dim 0, the row-parallel
o and wo dim 1.

The training-only helpers (``shard_params``, the ZeRO optimizer-state
specs) go with data-parallel training (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ripor_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, axis_size,
                                       shard)

Spec = Tuple


def param_partition_spec(name: str, leaf) -> Spec:
    """Spec for one parameter, keyed by its state_dict name."""
    parts = name.split(".")
    if getattr(leaf, "ndim", 0) < 2:
        return ()
    if parts[-1] == "weight":
        # attention projections: q/k/v [inner, d] split inner; o [d, inner]
        if parts[-2] in ("q", "k", "v"):
            return (MODEL_AXIS, None)
        # FFN: wi/wi_0/wi_1 [d_ff, d] split d_ff; wo [d, d_ff]
        if parts[-2] in ("o", "wo"):
            return (None, MODEL_AXIS)
        if "wi" in parts[-2]:
            return (MODEL_AXIS, None)
        # token embedding [vocab, d]: split vocab
        if name == "shared.weight":
            return (MODEL_AXIS, None)
    # codebooks [M, K, d], rel-pos tables, norms: replicate
    return ()


def params_pspec_tree(params: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    return {k: param_partition_spec(k, v) for k, v in params.items()}


def decode_param_partition_spec(name: str, leaf) -> Spec:
    """Tensor-parallel spec for one parameter on the DECODE path: as
    :func:`param_partition_spec` except that (a) the token embedding
    replicates — lookups use global ids, a vocab shard would zero the rows
    it lacks — and (b) the relative-position tables [buckets, H] split by
    head, so each rank's attention sees exactly its heads."""
    if name == "shared.weight":
        return ()
    if name.endswith("rel_bias.rel_embedding"):
        return (None, MODEL_AXIS)
    return param_partition_spec(name, leaf)


def decode_params_pspec_tree(params: Mapping[str, torch.Tensor]
                             ) -> Dict[str, Spec]:
    return {k: decode_param_partition_spec(k, v) for k, v in params.items()}


def _local(x: torch.Tensor, spec: Spec, axis: str, n: int, i: int):
    """Part i of n of ``x`` along each dim that ``spec`` splits over
    ``axis``."""
    for dim, ax in enumerate(spec):
        if ax == axis:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide the {axis!r} axis ({n})")
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x.contiguous()


def shard_decode_params(params: Mapping[str, torch.Tensor], mesh
                        ) -> Dict[str, torch.Tensor]:
    """This rank's model-coordinate slice of an UNSHARDED state_dict, by
    :func:`decode_param_partition_spec`: the state_dict of the per-rank
    model whose config has num_heads and d_ff divided by the model axis."""
    n, i = axis_size(mesh, MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS)
    return {k: _local(v, decode_param_partition_spec(k, v), MODEL_AXIS, n, i)
            for k, v in params.items()}


def batch_sharding(mesh) -> Tuple:
    """Placements of a batch: leading dim split over 'data'."""
    return shard(mesh, DATA_AXIS)


def shard_batch(batch, mesh):
    """This rank's data slice of every array of ``batch`` (a mapping,
    list or tuple of numpy arrays or tensors, nested) along its leading
    (batch) dim, which must divide the 'data' axis. Every rank passes the
    same global batch (the reference's DistributedSampler contract,
    t5_pretrainer/main.py:116-124, with the split made here)."""
    n, i = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)

    def put(x):
        if isinstance(x, Mapping):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide the 'data' axis "
                             f"({n})")
        return x[i * (b // n):(i + 1) * (b // n)]
    return put(batch)
