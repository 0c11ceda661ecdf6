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

The training helpers: ``shard_params`` (this rank's slice by the
training table), and the ZeRO optimizer-state rules
(``opt_moment_spec``, ``opt_state_pspec_tree``, ``shard_opt_state``) that
train/trainer.py's ``Trainer(mesh=, shard_opt_state=True)`` keeps its
Adam moments by. A JAX array put on a mesh is one global array; here each
rank holds its block: along every dim a spec splits over an axis of n
ranks, rank i of that axis holds rows [size*i//n, size*(i+1)//n)
(``span``), so a dim that does not divide the axis still splits.
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


def span(size: int, n: int, i: int) -> Tuple[int, int]:
    """Rows [start, stop) of part i of n of a dim of ``size`` rows."""
    return size * i // n, size * (i + 1) // n


def block_index(shape, spec: Spec, mesh, coord=None) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that make the block held by
    the rank at ``coord`` ({axis: index}; None: this rank) by ``spec``
    (``span`` along each split dim)."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
        else:
            i = mesh.get_local_rank(axis) if coord is None else coord[axis]
            out.append(slice(*span(shape[dim], axis_size(mesh, axis), i)))
    return tuple(out)


def local_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` by ``spec``, contiguous and in storage
    of its own: a view would keep the whole of ``x`` alive (a ZeRO
    moment would then hold as many bytes as the replicated one)."""
    return x[block_index(x.shape, spec, mesh)].clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Mapping[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's block of every param by :func:`param_partition_spec`
    (the training table: the token embedding's vocab dim splits). The
    Trainer keeps params whole, as the JAX Trainer does; this is the JAX
    ``shard_params`` for a caller that holds TP blocks."""
    return {k: local_block(v, param_partition_spec(k, v), mesh)
            for k, v in params.items()}


def opt_moment_spec(param_spec: Spec, leaf) -> Spec:
    """ZeRO-style spec for one optimizer moment: keep the param's TP axes
    and split the largest remaining free dim over 'data', unless it is
    smaller than 8 (replication is cheaper), as the JAX rule does. The
    port's Linear weight is the transpose of the flax kernel, so the
    split dim flips with it; a tie between free dims (none in RiporModel:
    every 2-D Linear weight has a TP axis) takes the first, as JAX does."""
    ndim = getattr(leaf, "ndim", 0)
    if ndim == 0:
        return ()
    spec = (list(param_spec) + [None] * ndim)[:ndim]
    free = [i for i, a in enumerate(spec) if a is None]
    if not free:
        return tuple(spec)
    largest = max(free, key=lambda i: leaf.shape[i])
    if leaf.shape[largest] < 8:
        return tuple(spec)
    spec[largest] = DATA_AXIS
    return tuple(spec)


def opt_state_pspec_tree(opt_state: Mapping, params: Mapping[str, torch.Tensor]
                         ) -> Dict:
    """Specs of an ``AdamW.init`` state ({count, mu, nu} by param name):
    mu and nu take :func:`opt_moment_spec` of their param's spec, the
    step count replicates."""
    specs = params_pspec_tree(params)
    return {k: ({n: opt_moment_spec(specs[n], v) for n, v in tree.items()}
                if isinstance(tree, Mapping) else ())
            for k, tree in opt_state.items()}


def shard_opt_state(opt_state: Mapping, params: Mapping[str, torch.Tensor],
                    mesh) -> Dict:
    """This rank's ZeRO blocks of an optimizer state whose moments are
    whole, by :func:`opt_state_pspec_tree`."""
    specs = opt_state_pspec_tree(opt_state, params)
    return {k: ({n: local_block(v, specs[k][n], mesh)
                 for n, v in tree.items()}
                if isinstance(tree, Mapping) else tree)
            for k, tree in opt_state.items()}


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


class DataSlice(dict):
    """A batch that is already this rank's 'data' slice (what
    :func:`shard_batch` returns for a mapping): sharding it again, or
    handing it to ``Trainer.run`` on a mesh, leaves it as it is, as a JAX
    array already on its sharding is left."""


def shard_batch(batch, mesh, dim: int = 0):
    """This rank's data slice of every array of ``batch`` (a mapping,
    list or tuple of numpy arrays or tensors, nested) along its leading
    (batch) dim, which must divide the 'data' axis (``dim`` 1: the
    micro-batch dim of a [accum, micro, ...] batch). Every rank passes the
    same global batch (the reference's DistributedSampler contract,
    t5_pretrainer/main.py:116-124, with the split made here). A mapping
    comes back as a :class:`DataSlice`; a DataSlice is returned as it is."""
    if isinstance(batch, DataSlice):
        return batch
    n, i = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)

    def put(x):
        if isinstance(x, Mapping):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        b = x.shape[dim]
        if b % n:
            raise ValueError(f"batch {b} does not divide the 'data' axis "
                             f"({n})")
        return x[(slice(None),) * dim + (slice(i * (b // n),
                                                (i + 1) * (b // n)),)]
    out = put(batch)
    return DataSlice(out) if isinstance(batch, Mapping) else out
