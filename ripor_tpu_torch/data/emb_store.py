"""Sharded document-embedding store — a copy of
ripor_tpu/data/emb_store.py (host-side numpy; it reaches no kernel).

The reference persists the 8.8M x 768 fp32 corpus encoding as per-rank
chunked npy shards plus a merge plan, then aggregates into a single memmap
(reference DenseIndexing.store_embs tasks/evaluator.py:494-555 writes
``embs_{rank}_{chunk}.npy`` / ``text_ids_{rank}_{chunk}.npy`` + plan.json;
``aggregate_embs_to_mmap`` :636-692 merges to ``doc_embeds.mmap`` +
``text_ids.tsv``). The files are byte-compatible with the JAX package's
both ways: shards and mmaps written by one package are read by the other.
Host shards are explicit ``rank``s of ``nranks`` (any worker id).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


class ShardWriter:
    """Streams (embeddings, ids) batches to chunked npy shards for one host.

    Mirrors store_embs' chunking: a new chunk is cut every
    ``chunk_size`` rows so no single file (or host buffer) holds the
    whole corpus shard.
    """

    def __init__(self, out_dir: str | Path, rank: int = 0,
                 chunk_size: int = 500_000):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self.chunk_size = chunk_size
        self._embs: List[np.ndarray] = []
        self._ids: List = []
        self._buffered = 0
        self._chunk = 0
        self.chunks_written = 0

    def add(self, embs: np.ndarray, ids: Sequence) -> None:
        embs = np.asarray(embs, np.float32)
        assert embs.shape[0] == len(ids), (embs.shape, len(ids))
        self._embs.append(embs)
        self._ids.extend(ids)
        self._buffered += embs.shape[0]
        while self._buffered >= self.chunk_size:
            self._flush_chunk(self.chunk_size)

    def _flush_chunk(self, n: int) -> None:
        flat = np.concatenate(self._embs, axis=0)
        chunk_embs, rest = flat[:n], flat[n:]
        chunk_ids, self._ids = self._ids[:n], self._ids[n:]
        self._embs = [rest] if rest.size else []
        self._buffered = rest.shape[0] if rest.size else 0
        np.save(self.dir / f"embs_{self.rank}_{self._chunk}.npy", chunk_embs)
        np.save(self.dir / f"text_ids_{self.rank}_{self._chunk}.npy",
                np.asarray(chunk_ids))
        self._chunk += 1
        self.chunks_written += 1

    def finalize(self) -> int:
        """Flush the tail chunk; returns number of chunks written."""
        if self._buffered:
            self._flush_chunk(self._buffered)
        return self.chunks_written


def write_plan(out_dir: str | Path, nranks: int) -> dict:
    """plan.json: {"nranks": R, "num_chunks": {rank: n}} (evaluator.py:546-555
    writes an equivalent merge plan once all ranks finish)."""
    out_dir = Path(out_dir)
    counts = {}
    for r in range(nranks):
        n = 0
        while (out_dir / f"embs_{r}_{n}.npy").exists():
            n += 1
        counts[str(r)] = n
    plan = {"nranks": nranks, "num_chunks": counts}
    with open(out_dir / "plan.json", "w") as f:
        json.dump(plan, f)
    return plan


def iter_shards(emb_dir: str | Path) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Yield (embs, ids) chunk-by-chunk in rank-major order per plan.json."""
    emb_dir = Path(emb_dir)
    with open(emb_dir / "plan.json") as f:
        plan = json.load(f)
    for r in range(plan["nranks"]):
        for c in range(plan["num_chunks"][str(r)]):
            yield (np.load(emb_dir / f"embs_{r}_{c}.npy"),
                   np.load(emb_dir / f"text_ids_{r}_{c}.npy",
                           allow_pickle=False))


def merge_to_mmap(emb_dir: str | Path, mmap_dir: str | Path,
                  d: Optional[int] = None) -> Tuple[str, int]:
    """Aggregate all shards into doc_embeds.mmap (fp32 row-major) +
    text_ids.tsv, the exact on-disk artifacts of aggregate_embs_to_mmap
    (evaluator.py:636-692) that every downstream stage reads. Streams
    chunk-by-chunk — never materializes the full matrix.

    Returns (mmap_path, total_rows)."""
    mmap_dir = Path(mmap_dir)
    mmap_dir.mkdir(parents=True, exist_ok=True)
    total, dim = 0, d
    for embs, _ in iter_shards(emb_dir):
        total += embs.shape[0]
        dim = dim or embs.shape[1]
        assert embs.shape[1] == dim, (embs.shape, dim)
    mmap_path = mmap_dir / "doc_embeds.mmap"
    out = np.memmap(mmap_path, dtype=np.float32, mode="w+",
                    shape=(total, dim))
    row = 0
    with open(mmap_dir / "text_ids.tsv", "w") as idf:
        for embs, ids in iter_shards(emb_dir):
            out[row:row + embs.shape[0]] = embs
            row += embs.shape[0]
            for i in ids:
                idf.write(f"{i}\n")
    out.flush()
    with open(mmap_dir / "meta.json", "w") as f:
        json.dump({"rows": total, "dim": dim, "dtype": "float32"}, f)
    return str(mmap_path), total


def open_mmap(mmap_dir: str | Path, d: Optional[int] = None
              ) -> Tuple[np.memmap, List[str]]:
    """Read-only view over doc_embeds.mmap + its docid list. ``d`` is only
    needed for reference-produced dirs that lack meta.json (the reference
    hardcodes .reshape(-1, 768), evaluator.py:45)."""
    mmap_dir = Path(mmap_dir)
    meta_path = mmap_dir / "meta.json"
    if meta_path.exists():
        with open(meta_path) as f:
            d = json.load(f)["dim"]
    if d is None:
        raise ValueError("dim unknown: no meta.json; pass d explicitly")
    arr = np.memmap(mmap_dir / "doc_embeds.mmap", dtype=np.float32,
                    mode="r").reshape(-1, d)
    with open(mmap_dir / "text_ids.tsv") as f:
        ids = [line.rstrip("\n") for line in f]
    assert len(ids) == arr.shape[0], (len(ids), arr.shape)
    return arr, ids


def host_shard_slice(total: int, rank: int, nranks: int) -> slice:
    """Contiguous per-host row range (replaces DistributedSampler doc
    sharding, evaluate.py:210): host r gets rows [r*ceil .. min(end)]."""
    per = -(-total // nranks)
    return slice(rank * per, min((rank + 1) * per, total))
