"""A one-process reference for the tensor-parallel search.

Under tensor parallelism (decode/beam.py::make_tp_beam_search_fn) every
attention and FFN output projection is the sum, over the 'model' axis,
of each rank's partial product over its slice of the contraction (its
heads, its d_ff columns). :func:`split_sums` makes a one-process model
take the same sums with no process group: the search a bf16 TP search
equals, where the order of those sums alone moves it away from the plain
one-process search.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as Fn

from ripor_tpu_torch.models.layers import Attention, FeedForward


@contextlib.contextmanager
def split_sums(model: torch.nn.Module, parts: int = 2):
    """Within the block, the output projection of every Attention (``o``)
    and FeedForward (``wo``) in ``model`` is the sum of ``parts`` partial
    products over equal contiguous slices of its contraction, each in the
    activations' dtype, added in rank order: what a model axis of
    ``parts`` ranks all-reduces. Only the projections are replaced; the
    rest of each module (the gated FFN, dropout) runs as it is.

    Raises ValueError for a per-rank model (one with a TP group) or a
    contraction that ``parts`` does not divide, and, on leaving the block,
    RuntimeError unless every replaced projection ran through its Linear
    (an ``ffn_int8`` search applies a quantized copy of wo, which this
    does not mirror)."""
    linears = []
    for m in model.modules():
        if isinstance(m, (Attention, FeedForward)):
            if m.tp_group is not None:
                raise ValueError("split_sums takes a one-process model, "
                                 "not one rank of a TP group")
            linears.append(m.o if isinstance(m, Attention) else m.wo)
    calls = [0] * len(linears)

    def forward(i, w_parts, x):
        calls[i] += 1
        n = x.shape[-1] // parts
        y = None
        for p, w in enumerate(w_parts):
            part = Fn.linear(x[..., p * n:(p + 1) * n].contiguous(), w)
            y = part if y is None else y + part
        return y

    for i, lin in enumerate(linears):
        n, rem = divmod(lin.in_features, parts)
        if rem or lin.bias is not None:
            raise ValueError(f"split_sums: {lin} does not split into "
                             f"{parts} bias-free slices")
        w_parts = [lin.weight[:, p * n:(p + 1) * n].contiguous()
                   for p in range(parts)]
        lin.forward = lambda x, i=i, w=w_parts: forward(i, w, x)
    try:
        yield model
    finally:
        for lin in linears:
            del lin.forward
    if not all(calls):
        raise RuntimeError(
            f"split_sums: {calls.count(0)} of {len(calls)} output "
            "projections did not run through their Linear (an ffn_int8 "
            "search applies a quantized wo, which split_sums does not "
            "mirror)")
