"""Succinct device trie: packed bitmask + rank-addressed edge array.

The dense child table (``DocIdTrie.children``, int32 [nodes, K]) costs
4*K bytes per internal node — ~1 KB at K=256 and 4 KB at K=1024, which for
the 8.8M-doc corpus (millions of internal nodes) runs into multiple GB of
HBM and was flagged as the design's memory hard-part (SURVEY.md §7.3,
BASELINE config #4: the 16x1024 variant). This representation stores:

* ``bits``:  uint32 [nodes, K/32] — bit (tok % 32) of word (tok // 32) set
             iff some smtid continues with ``tok`` (32x smaller than the
             dense table; also 32x less gather bandwidth per decode step);
* ``node_base``: int32 [nodes + 1] — prefix sum of node out-degrees;
* ``edge_child``: int32 [sum degrees] — child entries sorted by
             (node, token), same value semantics as the dense table
             (>= 0 internal id, <= -2 singleton chain -2-group).

Child lookup is rank addressing: ``edge_child[node_base[n] +
popcount(bits[n] & mask_below(tok))]`` — plain tensor gathers + a SWAR
popcount, computed only for the top-k winning (beam, token) pairs (the
dense path materialized whole [B, N, K] child rows).

Reference analogue: the per-step prefix->next-ids dicts / CSR matrices
(tasks/generation.py:603-677) — this is their memory-scalable device form.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TrieTables(NamedTuple):
    """Constrained-decoding tables: numpy arrays from ``succinct_tables``,
    or device tensors from ``tables_to_torch``."""
    bits: "np.ndarray"          # uint32 [nodes, ceil(K/32)]
    node_base: "np.ndarray"     # int32 [nodes + 1]
    edge_child: "np.ndarray"    # int32 [E]
    # narrowest uint dtype that holds K-1 (uint8 for K<=256): at 8.8M docs
    # this [G, M] table is the dominant HBM term (int32 would be 1.1 GB at
    # M=32; uint8 is 282 MB) and it competes with the int8 KV cache for
    # headroom (SURVEY §7.3). Consumers cast the gathered scalar up.
    unique_codes: "np.ndarray"  # uint8/uint16/int32 [G, M]


def succinct_tables(trie) -> TrieTables:
    """Convert a DocIdTrie's dense child table into succinct tables."""
    children = np.asarray(trie.children)
    nodes, K = children.shape
    W = -(-K // 32)
    valid = children != -1                              # [nodes, K]
    if K % 32:
        valid = np.concatenate(
            [valid, np.zeros((nodes, 32 * W - K), bool)], axis=1)
    # bit r of word w <-> token 32*w + r
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    bits = (valid.reshape(nodes, W, 32).astype(np.uint32)
            * weights[None, None, :]).sum(axis=2, dtype=np.uint32)
    deg = (children != -1).sum(axis=1)
    node_base = np.zeros(nodes + 1, np.int32)
    np.cumsum(deg, out=node_base[1:], dtype=np.int32)
    edge_child = children[children != -1].astype(np.int32)  # (node, tok) order
    code_dt = (np.uint8 if K <= 256
               else np.uint16 if K <= 65536 else np.int32)
    return TrieTables(bits=bits, node_base=node_base, edge_child=edge_child,
                      unique_codes=np.asarray(trie.unique_codes, code_dt))


def dummy_tables(M: int) -> TrieTables:
    """Placeholder tables for unconstrained decoding."""
    return TrieTables(bits=np.zeros((1, 1), np.uint32),
                      node_base=np.zeros(2, np.int32),
                      edge_child=np.zeros(1, np.int32),
                      unique_codes=np.zeros((1, M), np.int32))


def tables_memory_bytes(tables: TrieTables) -> int:
    return sum(np.asarray(x).nbytes for x in tables)


def tables_to_torch(tables: TrieTables, device) -> TrieTables:
    """Move numpy tables to ``device`` as torch tensors.

    ``bits`` widens uint32 -> int64: torch's uint32 support is thin (no
    shifts or bitwise ops on every backend), and the 32 payload bits sit
    in the low half of an int64 with room for the SWAR popcount's
    multiply. ``node_base`` widens to int64 so it indexes directly;
    ``unique_codes`` keeps its narrow dtype (uint8 for K <= 256) and the
    decoder casts the gathered codes up."""
    import torch
    return TrieTables(
        bits=torch.as_tensor(np.asarray(tables.bits).astype(np.int64),
                             device=device),
        node_base=torch.as_tensor(
            np.asarray(tables.node_base).astype(np.int64), device=device),
        edge_child=torch.as_tensor(
            np.asarray(tables.edge_child).astype(np.int32), device=device),
        unique_codes=torch.as_tensor(np.asarray(tables.unique_codes),
                                     device=device))
