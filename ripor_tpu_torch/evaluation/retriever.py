"""Dense retrieval: brute-force inner-product top-k, in PyTorch.

Port of ripor_tpu/evaluation/retriever.py (replaces faiss IndexFlatIP of
the reference, tasks/evaluator.py:480-492,616-623,784-812, and its corpus
encoding, DenseIndexing.store_embs, :494-555).

``dense_topk`` has the JAX function's three single-device routes: a numpy
corpus streams to the device in blocks whose top-k merge on the host; a
corpus tensor (``device_corpus``) is scanned where it lies, block by block,
with a running top-k on the device; an ``Int8Corpus`` is scanned the same
way, each block dequantized and its per-row scale folded into the scores.
Scores are float32 from bfloat16 operands: every product exact and summed
in f32 (``torch.mm(..., out_dtype=torch.float32)`` on the card, an f32
product of the widened operands on the CPU), as the JAX package's
``preferred_element_type=jnp.float32``. The top-k is exact (``torch.topk``
per block; the JAX package's tile-max pruning served the TPU's sort and
has no counterpart here, nor has its RIPOR_DENSE_TILE). ``approx=True``
takes the exact route, which is what ``jax.lax.approx_max_k`` does off the
TPU. Among equal scores ``torch.topk`` orders indices in no promised way,
where ``lax.top_k`` puts the lower index first.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Tuple

import numpy as np
import torch

from ripor_tpu_torch.core.mesh import DATA_AXIS, all_gather_cat, axis_size
from ripor_tpu_torch.decode.beam import resolve_device
from ripor_tpu_torch.quantize.kmeans import exact_f32


class Int8Corpus(NamedTuple):
    """Device corpus quantized to one byte/dim with a per-row scale: half
    the device memory of bf16 (8.8M x 768 in 6.8 GB)."""
    codes: torch.Tensor     # [N, d] int8 (row / scale, rounded)
    scale: torch.Tensor     # [N] f32  (row abs-max / 127)


def device_corpus(docs, dtype=torch.bfloat16, chunk: int = 1_000_000,
                  device=None):
    """Upload a corpus once for serving, optionally down-cast: bf16 (8.8M x
    768 in 13.6 GB), or ``dtype=torch.int8`` for per-row-scaled int8 rows
    (:class:`Int8Corpus`): scale = max(absmax / 127, 1e-12), codes =
    rint(row / scale), quantized in ``chunk`` rows to bound the transient.
    ``docs``: numpy, e.g. a memmap (uploaded in ``chunk`` rows; int8 rows
    quantized on the host, as the JAX package does), or a tensor
    (quantized where it lies, e.g. a corpus made on the card).
    ``device``: where the result lives (default "cuda"; a tensor's own
    device when ``docs`` is a tensor and ``device`` is None)."""
    on_tensor = isinstance(docs, torch.Tensor)
    dev = docs.device if on_tensor and device is None else \
        resolve_device(device)
    n = docs.shape[0]
    if dtype != torch.int8:
        if on_tensor:
            return docs.to(device=dev, dtype=dtype)
        out = torch.empty(docs.shape, dtype=dtype, device=dev)
        for s in range(0, n, chunk):
            out[s:s + chunk] = torch.from_numpy(
                np.array(docs[s:s + chunk], np.float32))
        return out
    if on_tensor:
        codes = torch.empty(docs.shape, dtype=torch.int8, device=docs.device)
        scale = torch.empty((n,), dtype=torch.float32, device=docs.device)
        for s in range(0, n, chunk):
            blk = docs[s:s + chunk].to(torch.float32)
            sc = torch.clamp(blk.abs().amax(dim=1) / 127.0, min=1e-12)
            codes[s:s + chunk] = torch.round(blk / sc[:, None]).to(torch.int8)
            scale[s:s + chunk] = sc
            del blk
        return Int8Corpus(codes.to(dev), scale.to(dev))
    x = np.asarray(docs)
    codes = np.empty(x.shape, np.int8)
    scale = np.empty((n,), np.float32)
    for s in range(0, n, chunk):
        blk = np.asarray(x[s:s + chunk], np.float32)
        sc = np.maximum(np.abs(blk).max(axis=1) / 127.0, 1e-12)
        codes[s:s + chunk] = np.rint(blk / sc[:, None]).astype(np.int8)
        scale[s:s + chunk] = sc
    return Int8Corpus(torch.as_tensor(codes, device=dev),
                      torch.as_tensor(scale, device=dev))


def _scores(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """f32 scores [Q, N] of q [Q, d] against docs [N, d] of q's dtype: each
    product exact and summed in f32 (TF32 off for an f32 corpus)."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        return torch.mm(q, docs.T, out_dtype=torch.float32)
    with exact_f32():
        return q.float() @ docs.float().T


def _merge(best_s, best_i, bs, bi, k):
    """Running top-k on the device: the best k of two candidate lists."""
    all_s = torch.cat([best_s, bs], dim=1)
    all_i = torch.cat([best_i, bi], dim=1)
    gs, gsel = torch.topk(all_s, k, dim=1)
    return gs, torch.gather(all_i, 1, gsel)


def _topk_scan_device(queries, docs, k, block, nblocks, scale=None):
    """Streaming top-k over a corpus tensor, on its device: ``nblocks``
    blocks of ``block`` rows with a running top-k, so the transient is one
    block's scores. The tail block clamps its start to ``n - block`` (one
    shape throughout) and masks the re-scored overlap rows to -inf, so
    every doc is counted exactly once. ``scale``: the Int8Corpus's per-row
    scales (the block is widened to the queries' dtype, the scale folded
    into its scores)."""
    n = docs.shape[0]
    q = queries.shape[0]
    best_s = torch.full((q, k), float("-inf"), device=docs.device)
    best_i = torch.zeros((q, k), dtype=torch.int64, device=docs.device)
    for b in range(nblocks):
        start = min(b * block, n - block)
        blk = docs[start:start + block]
        if scale is not None:
            blk = blk.to(queries.dtype)
        s = _scores(queries, blk)
        if scale is not None:
            s *= scale[start:start + block][None, :].to(torch.float32)
        if start < b * block:
            s[:, :b * block - start] = float("-inf")
        bs, bi = torch.topk(s, min(k, block), dim=1)
        del s
        best_s, best_i = _merge(best_s, best_i, bs, bi + start, k)
    return best_s, best_i


# rows a scan block is a multiple of: the block is the scores' row stride,
# and an odd one sends cuBLAS to an unaligned GEMM (2.6x slower on the
# card). The JAX package rounds to its pruning tile, also 256 rows.
_BLOCK_ROWS = 256


def _scan_blocks(n: int, block_docs: int) -> Tuple[int, int]:
    """(block, nblocks) of the device scan: blocks of at most
    ``block_docs`` rows, evened out over the corpus and rounded up to a
    multiple of _BLOCK_ROWS (the tail block then overlaps its neighbour);
    one block of n rows for a corpus under two multiples."""
    block = min(block_docs, n)
    if n >= 2 * _BLOCK_ROWS:
        nblocks = -(-n // block)
        block = -(-n // (nblocks * _BLOCK_ROWS)) * _BLOCK_ROWS
        while block > n:
            nblocks += 1
            block = -(-n // (nblocks * _BLOCK_ROWS)) * _BLOCK_ROWS
    return block, -(-n // block)


def dense_topk(queries, docs, k: int, mesh=None,
               block_docs: int = 1_000_000, approx: bool = False,
               device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force IP top-k -> (scores [Q, k] f32, indices [Q, k] int64),
    numpy, best first. ``docs``: a numpy array (blocks of ``block_docs``
    rows go to ``device``, default "cuda", and merge on the host by a
    stable argsort), a corpus tensor from :func:`device_corpus` (scanned
    on its device), or an :class:`Int8Corpus`. Queries are cast to the
    corpus's dtype (bf16 for an Int8Corpus, f32 for numpy). ``approx`` is
    accepted and exact (module docstring). ``mesh``: the corpus rows split
    over the mesh's 'data' axis when they divide it (SPMD: every rank
    passes the same queries and corpus and gets the same top-k); an
    Int8Corpus is refused there."""
    scale = None
    if isinstance(docs, Int8Corpus):
        if mesh is not None:
            raise NotImplementedError(
                "Int8Corpus is the single-card capacity path; use a bf16 "
                "device_corpus with the mesh (it already shards)")
        docs, scale = docs.codes, docs.scale
    n = docs.shape[0]
    k = min(k, n)
    on_device = isinstance(docs, torch.Tensor)
    dev = docs.device if on_device else resolve_device(device)
    qdtype = (torch.bfloat16 if scale is not None
              else docs.dtype if on_device else torch.float32)
    queries = torch.as_tensor(np.asarray(queries)).to(device=dev,
                                                      dtype=qdtype)
    if mesh is not None and n % axis_size(mesh, DATA_AXIS) == 0:
        return _dense_topk_mesh(queries, docs, k, mesh, block_docs)

    with torch.inference_mode():
        if on_device:
            block, nblocks = _scan_blocks(n, block_docs)
            gs, gi = _topk_scan_device(queries, docs, k, block, nblocks,
                                       scale=scale)
            return gs.cpu().numpy(), gi.cpu().numpy()

        best_s = np.full((queries.shape[0], k), -np.inf, np.float32)
        best_i = np.zeros((queries.shape[0], k), np.int64)
        for s in range(0, n, block_docs):
            blk = torch.as_tensor(np.array(docs[s:s + block_docs],
                                           np.float32), device=dev)
            bs, bi = torch.topk(_scores(queries, blk), min(k, blk.shape[0]),
                                dim=1)
            bs, bi = bs.cpu().numpy(), bi.cpu().numpy() + s
            all_s = np.concatenate([best_s, bs], axis=1)
            all_i = np.concatenate([best_i, bi], axis=1)
            sel = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
            best_s = np.take_along_axis(all_s, sel, axis=1)
            best_i = np.take_along_axis(all_i, sel, axis=1)
        return best_s, best_i


def _dense_topk_mesh(queries, docs, k, mesh, block_docs):
    """The corpus rows split over 'data': each rank scans its n/ndata rows
    (on the queries' device) for a local top-k with global row ids, then
    only the [Q, k] candidates are gathered over the data group, never
    [Q, N], and merged by one more top-k."""
    nshards = axis_size(mesh, DATA_AXIS)
    size = docs.shape[0] // nshards
    lo = mesh.get_local_rank(DATA_AXIS) * size
    local = docs[lo:lo + size]
    if not isinstance(local, torch.Tensor):
        local = torch.as_tensor(np.array(local, np.float32),
                                device=queries.device)
    group = mesh.get_group(DATA_AXIS)
    with torch.inference_mode():
        block, nblocks = _scan_blocks(size, block_docs)
        ls, li = _topk_scan_device(queries, local, min(k, size), block,
                                   nblocks)
        ls = all_gather_cat(ls, group, dim=1)
        li = all_gather_cat(li + lo, group, dim=1)
        gs, gsel = torch.topk(ls, k, dim=1)
        gi = torch.gather(li, 1, gsel)
    return gs.cpu().numpy(), gi.cpu().numpy()


def encode_corpus(model, batches: Iterable[Dict], dtype=None) -> np.ndarray:
    """Encode a corpus of tokenized batches into dense reps [N, d] float32
    (reference DenseIndexing.store_embs, tasks/evaluator.py:494-555):
    ``model.dense_rep`` (a RiporModel; it computes in its own dtype on its
    device) over each batch {"input_ids", "attention_mask"[, "n_valid"]}.
    ``dtype`` is read by neither package (the JAX signature's)."""
    dev = next(model.parameters()).device
    out = []
    with torch.inference_mode():
        for b in batches:
            r = model.dense_rep(torch.as_tensor(b["input_ids"], device=dev),
                                torch.as_tensor(b["attention_mask"],
                                                device=dev))
            n = b.get("n_valid", r.shape[0])
            out.append(r.float().cpu().numpy()[:n])
    return np.concatenate(out, axis=0)


def aq_flat_search(query_embs: np.ndarray, codebooks, codes: np.ndarray,
                   k: int, mesh=None, device=None):
    """Sanity-check retrieval over AQ *reconstructions*: doc rep = sum of
    codebook embeddings (reference aq_to_flat_index_search_evaluate,
    evaluate.py:334-394 / T5AQEncoder summed decode :899-900). Verifies the
    quantized DocIDs retrieve ~ as well as the RQ index itself."""
    from ripor_tpu_torch.quantize.rq import rq_decode
    recon = rq_decode(codebooks, codes)
    return dense_topk(query_embs, recon, k, mesh=mesh, device=device)


def retrieve_to_run(query_ids: list, docids: list, scores: np.ndarray,
                    indices: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Assemble a trec run dict {qid: {docid: score}} (reference
    DenseRetriever.retrieve writes run.json, tasks/evaluator.py:707-731)."""
    run = {}
    for qi, qid in enumerate(query_ids):
        run[str(qid)] = {str(docids[int(d)]): float(s)
                         for s, d in zip(scores[qi], indices[qi])}
    return run
