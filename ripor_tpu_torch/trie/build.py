"""Tensorized DocID trie for constrained decoding.

Replaces the reference's per-step prefix dicts + scipy CSR matrices + host
string hashing (tasks/generation.py:603-677 PrefixConstrainLogitProcessorFastSparse,
aq_preprocess/build_list_smtid_to_nextids.py:20-41) with two device arrays:

* ``children``: int32 [num_internal_nodes, K] — one flat table for ALL trie
  levels (node ids are global, so the decode scan indexes it with a single
  gather, no per-level dispatch). Entry semantics:
      >= 0   : child is an internal node (subtree with >= 2 distinct smtids)
      == -1  : no smtid continues with this token (masked at decode)
      <= -2  : child subtree is a *singleton chain* — exactly one distinct
               smtid remains; value encodes ``-2 - group`` where ``group``
               indexes ``unique_codes``.
* ``unique_codes``: int32 [G, M] — the distinct smtids, lexicographically
  sorted. Once a beam enters a singleton chain its only allowed token at
  step t is ``unique_codes[group, t]`` (a gather + one-hot), so deep trie
  levels cost no table memory at all. This chain compression is what makes
  the 8.8M-doc trie fit in HBM (SURVEY.md §7.3).

Beam state is one int32 per hypothesis:
  0 (root) or positive: internal node id; <= -2: inside singleton chain for
  group ``-2 - state``. After the last step every live beam's state is a
  singleton code (<= -2), i.e. a retrieved smtid group; groups expand to
  docids on the host (reference groups smtid->docids at evaluate.py:439-449).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class DocIdTrie:
    children: np.ndarray        # int32 [num_internal, K]
    unique_codes: np.ndarray    # int32 [G, M]
    group_doc_offsets: np.ndarray  # int32 [G+1] — CSR offsets into group_docids
    group_docids: np.ndarray    # int32 [sum group sizes] — doc indices per group
    K: int

    @property
    def num_internal(self) -> int:
        return self.children.shape[0]

    @property
    def num_groups(self) -> int:
        return self.unique_codes.shape[0]

    @property
    def M(self) -> int:
        return self.unique_codes.shape[1]

    def docids_of_group(self, g: int) -> np.ndarray:
        return self.group_docids[self.group_doc_offsets[g]:self.group_doc_offsets[g + 1]]

    def memory_bytes(self) -> int:
        return (self.children.nbytes + self.unique_codes.nbytes
                + self.group_doc_offsets.nbytes + self.group_docids.nbytes)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, children=self.children, unique_codes=self.unique_codes,
            group_doc_offsets=self.group_doc_offsets,
            group_docids=self.group_docids, K=np.int64(self.K))

    @staticmethod
    def load(path: str) -> "DocIdTrie":
        z = np.load(path)
        return DocIdTrie(z["children"], z["unique_codes"],
                         z["group_doc_offsets"], z["group_docids"], int(z["K"]))


def build_trie(codes: np.ndarray, K: int,
               use_native: bool | None = None) -> DocIdTrie:
    """Build the flat trie from per-document codes [N, M] (ints in [0, K)).

    Vectorized host-side construction over lexicographically sorted unique
    codes: trie nodes at level i are runs of equal length-i prefixes; a run
    of >= 2 distinct smtids becomes an internal node, a run of exactly 1
    becomes a singleton-chain pointer.

    ``use_native`` routes to the C++ builder (native/ripor_native.cc,
    through native_ext); the default uses it for corpora above 200k docs
    when the library builds. Both builders give the same trie.
    """
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError("codes must be [N, M]")
    n, M = codes.shape
    if codes.min() < 0 or codes.max() >= K:
        raise ValueError(f"codes out of range [0, {K})")

    if use_native is None:
        use_native = n > 200_000
    if use_native:
        from ripor_tpu_torch.native_ext import trie_build_native
        result = trie_build_native(codes, K)
        if result is not None:
            children, unique_codes, group_doc_offsets, group_docids = result
            return DocIdTrie(children=children, unique_codes=unique_codes,
                             group_doc_offsets=group_doc_offsets,
                             group_docids=group_docids, K=K)

    # sort docs by code, group identical codes
    order = np.lexsort(codes.T[::-1])           # lexicographic over columns 0..M-1
    sorted_codes = codes[order].astype(np.int32)
    neq = np.any(sorted_codes[1:] != sorted_codes[:-1], axis=1)
    is_new_group = np.concatenate([[True], neq])
    group_of_sorted = np.cumsum(is_new_group) - 1          # [N] group per sorted doc
    unique_codes = sorted_codes[is_new_group]              # [G, M]
    G = unique_codes.shape[0]
    # CSR of docids per group
    group_sizes = np.bincount(group_of_sorted, minlength=G)
    group_doc_offsets = np.zeros(G + 1, np.int64)
    np.cumsum(group_sizes, out=group_doc_offsets[1:])
    group_docids = order.astype(np.int32)                  # sorted by group already

    # run ids of each prefix length over unique_codes
    # run_id[i][g] = index of the length-i prefix run containing row g
    run_id = [np.zeros(G, np.int64)]                       # level 0: all share root
    for i in range(1, M + 1):
        changed = np.any(unique_codes[1:, :i] != unique_codes[:-1, :i], axis=1)
        run_id.append(np.concatenate([[0], np.cumsum(changed)]))

    # run start/length per level
    def run_bounds(rid):
        starts = np.flatnonzero(np.concatenate([[True], rid[1:] != rid[:-1]]))
        lengths = np.diff(np.concatenate([starts, [G]]))
        return starts, lengths

    # assign global internal-node ids level by level
    # internal run: length >= 2 (root is always internal, even if G == 1)
    internal_id: List[np.ndarray] = []    # per level: run index -> global id or -1
    next_id = 0
    starts_per_level, lengths_per_level = [], []
    for i in range(M):                    # levels 0..M-1 have outgoing edges
        starts, lengths = run_bounds(run_id[i])
        starts_per_level.append(starts)
        lengths_per_level.append(lengths)
        internal = lengths >= 2 if i > 0 else np.ones_like(lengths, bool)
        ids = np.full(len(starts), -1, np.int64)
        ids[internal] = next_id + np.arange(int(internal.sum()))
        next_id += int(internal.sum())
        internal_id.append(ids)

    children = np.full((next_id, K), -1, np.int32)

    for i in range(M):
        # child runs at level i+1; a length-1 run contains exactly one group,
        # whose row index IS its start (runs are contiguous row ranges)
        if i + 1 < M:
            c_starts, _ = run_bounds(run_id[i + 1])
            child_internal = internal_id[i + 1]          # -1 where singleton
            child_val = np.where(child_internal >= 0, child_internal,
                                 -2 - c_starts.astype(np.int64))
        else:
            # last level: every child is a full code == one group
            c_starts = np.arange(G, dtype=np.int64)
            child_val = -2 - c_starts
        parent_gid = internal_id[i][run_id[i][c_starts]]
        live = parent_gid >= 0                           # only internal parents
        tok = unique_codes[c_starts, i]
        children[parent_gid[live], tok[live]] = child_val[live].astype(np.int32)

    return DocIdTrie(children=children, unique_codes=unique_codes,
                     group_doc_offsets=group_doc_offsets.astype(np.int64),
                     group_docids=group_docids, K=K)


# ---- oracle (for tests): dict-trie with identical semantics to the
# reference's Trie (utils/generation_utils.py:9-90) ----

def dict_trie(codes: Sequence[Sequence[int]]):
    root: dict = {}
    for row in codes:
        node = root
        for c in row:
            node = node.setdefault(int(c), {})
    return root


def dict_trie_allowed(root: dict, prefix: Sequence[int]) -> List[int]:
    node = root
    for c in prefix:
        if int(c) not in node:
            return []
        node = node[int(c)]
    return sorted(node.keys())
