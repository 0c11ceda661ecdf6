"""HNSW ANN dense baseline — a copy of ripor_tpu/evaluation/hnsw.py on
the port's native_ext copy (host code: the graph is C++, not a device
path). Parity with the reference's HNSWIndexer
(reference tasks/evaluator.py:28-190: faiss IndexHNSWFlat(d, num_links,
METRIC_INNER_PRODUCT), efConstruction=128, built from doc_embeds.mmap).

The graph lives in C++ (native/hnsw.cc, hnswlib-style parallel build);
without the native library the same API degrades to exact brute-force
search (slower but semantically a superset — HNSW is an approximation of
exactly that search).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ripor_tpu_torch import native_ext


class HnswIndex:
    """Inner-product ANN index over document embeddings.

    Mirrors the reference knobs: ``num_links`` (faiss HNSW M) and
    ``ef_construct``; search-time ``ef_search``.
    """

    def __init__(self, handle=None, vecs: Optional[np.ndarray] = None,
                 docids: Optional[Sequence[str]] = None):
        self._handle = handle          # native graph (preferred)
        self._vecs = vecs              # brute-force fallback storage
        self.docids = list(docids) if docids is not None else None

    @classmethod
    def build(cls, vecs: np.ndarray, num_links: int = 32,
              ef_construct: int = 128, docids: Optional[Sequence[str]] = None,
              n_threads: int = 0, seed: int = 0) -> "HnswIndex":
        vecs = np.ascontiguousarray(vecs, np.float32)
        handle = native_ext.hnsw_build_native(
            vecs, num_links=num_links, ef_construct=ef_construct,
            n_threads=n_threads, seed=seed)
        if handle is None:
            return cls(vecs=vecs, docids=docids)
        return cls(handle=handle, docids=docids)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    @property
    def size(self) -> int:
        return self._handle.size if self._handle is not None else len(self._vecs)

    def search(self, queries: np.ndarray, k: int, ef_search: int = 128,
               n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [nq, k] int64, scores [nq, k] f32), best first."""
        queries = np.ascontiguousarray(queries, np.float32)
        if self._handle is not None:
            out = native_ext.hnsw_search_native(
                self._handle, queries, k, ef_search=ef_search,
                n_threads=n_threads)
            if out is not None:
                return out
        sims = queries @ self._vecs.T
        k = min(k, sims.shape[1])
        idx = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        part = np.take_along_axis(sims, idx, axis=1)
        order = np.argsort(-part, axis=1, kind="stable")
        return (np.take_along_axis(idx, order, axis=1).astype(np.int64),
                np.take_along_axis(part, order, axis=1).astype(np.float32))

    def save(self, index_dir: str) -> None:
        """Writes model.index (+ docid list), like the reference layout
        (tasks/evaluator.py:65,94: faiss.write_index(..., 'model.index'))."""
        os.makedirs(index_dir, exist_ok=True)
        path = os.path.join(index_dir, "model.index")
        if self._handle is not None:
            ok = native_ext.hnsw_save_native(self._handle, path)
            if not ok:
                raise IOError(f"hnsw_save failed: {path}")
        else:
            np.save(path + ".flat.npy", self._vecs)
        if self.docids is not None:
            with open(os.path.join(index_dir, "docid"), "w") as f:
                json.dump(self.docids, f)

    @classmethod
    def load(cls, index_dir: str) -> "HnswIndex":
        path = os.path.join(index_dir, "model.index")
        docids = None
        docid_path = os.path.join(index_dir, "docid")
        if os.path.exists(docid_path):
            with open(docid_path) as f:
                docids = json.load(f)
        if os.path.exists(path):
            handle = native_ext.hnsw_load_native(path)
            if handle is None:
                raise IOError(f"cannot load native index: {path}")
            return cls(handle=handle, docids=docids)
        flat = path + ".flat.npy"
        if os.path.exists(flat):
            return cls(vecs=np.load(flat), docids=docids)
        raise FileNotFoundError(path)

    def retrieve_to_run(self, query_ids: Sequence[str], queries: np.ndarray,
                        k: int, ef_search: int = 128):
        """run.json-shaped output {qid: {docid: score}} (reference
        DenseRetriever.retrieve, tasks/evaluator.py:707-731)."""
        ids, scores = self.search(queries, k, ef_search=ef_search)
        docids = self.docids
        run = {}
        for qi, qid in enumerate(query_ids):
            row = {}
            for j in range(ids.shape[1]):
                di = int(ids[qi, j])
                if di < 0:
                    continue
                key = docids[di] if docids is not None else str(di)
                row[key] = float(scores[qi, j])
            run[str(qid)] = row
        return run


def recall_vs_exact(index: HnswIndex, vecs: np.ndarray, queries: np.ndarray,
                    k: int = 10, ef_search: int = 128) -> float:
    """Graph-quality diagnostic: overlap@k between ANN and exact IP search
    (the quantity in the reference's tuning comments, evaluator.py:42-44)."""
    ann_ids, _ = index.search(queries, k, ef_search=ef_search)
    sims = np.ascontiguousarray(queries, np.float32) @ vecs.T
    exact = np.argsort(-sims, axis=1)[:, :k]
    hits = 0
    for a, e in zip(ann_ids, exact):
        hits += len(set(a.tolist()) & set(e.tolist()))
    return hits / (len(queries) * k)
