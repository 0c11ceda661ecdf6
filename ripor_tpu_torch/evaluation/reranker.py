"""Teacher reranking engines — batched cross-encoder scoring, in PyTorch.

Port of ripor_tpu/evaluation/reranker.py, which mirrors tasks/reranker.py:
``rerank_pairs`` (Reranker.reranking, :31-59) scores (qid, docid) pairs of
a run; ``rerank_qid_smtid_docids`` (reranking_for_same_prefix_pair,
:61-92) scores (query, prefix-group, docid) triples into the rankdata
JSON the phase-3 flywheel consumes: {qid: {smtid: [[docid, score], ...]}}.

The scorer is injected as a callable ``ScoreFn`` (ids, mask) -> [B]
scores, numpy in and out (``load_bert_teacher`` returns one for a
BertCrossEncoder checkpoint), so the engine is model-agnostic; batches
have a fixed shape, the last padded with empty texts whose scores are
dropped. The functions that score with the RIPOR model itself take its
config and a state_dict and run it in ``dtype`` (default bfloat16, as the
JAX functions do) on ``device`` (default "cuda").
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ripor_tpu_torch.data.datasets import Collection, parse_smtid_str
from ripor_tpu_torch.data.tokenizer import (CLS_ID, EOS_ID, PAD_ID, SEP_ID,
                                            TextTokenizer, tokenize_docs,
                                            tokenize_queries)
from ripor_tpu_torch.decode.beam import resolve_device

ScoreFn = Callable[[np.ndarray, np.ndarray], np.ndarray]  # (ids, mask) -> [B]


def encode_pairs(tok: TextTokenizer, queries: Sequence[str],
                 docs: Sequence[str], max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """[CLS] query [SEP] doc [EOS], truncating the doc side first."""
    B = len(queries)
    ids = np.full((B, max_length), PAD_ID, np.int32)
    mask = np.zeros((B, max_length), np.int32)
    for i, (q, d) in enumerate(zip(queries, docs)):
        q_ids = tok.encode(q)[: max_length // 3]
        d_budget = max_length - len(q_ids) - 3
        d_ids = tok.encode(d)[:d_budget]
        row = [CLS_ID] + q_ids + [SEP_ID] + d_ids + [EOS_ID]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


def rerank_pairs(score_fn: ScoreFn, tok: TextTokenizer,
                 queries: Collection, docs: Collection,
                 pairs: Sequence[Tuple[str, str]], batch_size: int = 64,
                 max_length: int = 256) -> Dict[str, Dict[str, float]]:
    """Score (qid, docid) pairs -> {qid: {docid: score}} (reference
    Reranker.reranking, tasks/reranker.py:31-59)."""
    out: Dict[str, Dict[str, float]] = {}
    for s in range(0, len(pairs), batch_size):
        chunk = pairs[s:s + batch_size]
        pad = batch_size - len(chunk)
        q_texts = [queries[q] for q, _ in chunk] + [""] * pad
        d_texts = [docs[d] for _, d in chunk] + [""] * pad
        ids, mask = encode_pairs(tok, q_texts, d_texts, max_length)
        scores = np.asarray(score_fn(ids, mask), np.float32)[:len(chunk)]
        for (qid, did), sc in zip(chunk, scores):
            out.setdefault(str(qid), {})[str(did)] = float(sc)
    return out


def rerank_qid_smtid_docids(score_fn: ScoreFn, tok: TextTokenizer,
                            queries: Collection, docs: Collection,
                            qid_smtid_docids: Mapping[str, Mapping[str, Sequence[str]]],
                            batch_size: int = 64, max_length: int = 256
                            ) -> Dict[str, Dict[str, List[List]]]:
    """Score every (query, prefix-group, docid) triple -> rankdata
    {qid: {smtid: [[docid, score], ...]}} sorted by score desc (reference
    cross_encoder_rerank_for_qid_smtid_docids, rerank.py:587-654)."""
    triples: List[Tuple[str, str, str]] = []
    for qid, smtid_map in qid_smtid_docids.items():
        for smtid, docids in smtid_map.items():
            for did in docids:
                triples.append((str(qid), str(smtid), str(did)))
    pair_scores = rerank_pairs(score_fn, tok, queries, docs,
                               [(q, d) for q, _, d in triples],
                               batch_size, max_length)
    out: Dict[str, Dict[str, List[List]]] = {}
    for qid, smtid, did in triples:
        out.setdefault(qid, {}).setdefault(smtid, []).append(
            [did, pair_scores[qid][did]])
    for qid in out:
        for smtid in out[qid]:
            out[qid][smtid].sort(key=lambda x: -x[1])
    return out


def _ripor(cfg, params, dtype, device):
    """RiporModel(cfg) in ``dtype`` (default bfloat16) on ``device``
    holding the state_dict ``params``."""
    from ripor_tpu_torch.models.ripor import RiporModel
    model = RiporModel(cfg, dtype=dtype or torch.bfloat16,
                       device=resolve_device(device))
    model.load_state_dict(params)
    return model


def _on(model, *arrays):
    dev = next(model.parameters()).device
    return [torch.as_tensor(a).to(dev) for a in arrays]


def self_rerank_pair_scores(cfg, params, tok: TextTokenizer,
                            queries: Collection,
                            docid_to_codes: Mapping[str, "np.ndarray"],
                            pairs: Sequence[Tuple[str, str]],
                            batch_size: int = 64, max_length: int = 64,
                            dtype=None, device=None
                            ) -> Dict[str, Dict[str, float]]:
    """Self-distillation teacher: score (qid, docid) pairs with the RIPOR
    model's own sequential dot product over the doc's FULL smtid
    (RiporModel.rerank_score — the reference quantity at
    t5_generative_retriever.py:794-798). Used by the datagen flywheel when
    no cross-encoder checkpoint is supplied. Returns {qid: {docid: score}}."""
    model = _ripor(cfg, params, dtype, device)
    uniq = sorted({(str(q), str(d)) for q, d in pairs})
    out: Dict[str, Dict[str, float]] = {}
    for st in range(0, len(uniq), batch_size):
        chunk = uniq[st:st + batch_size]
        pad = batch_size - len(chunk)
        texts = [queries[q] for q, _ in chunk] + [""] * pad
        ids, mask = tokenize_queries(tok, texts, max_length)
        codes = np.zeros((batch_size, cfg.M), np.int32)
        for i, (_, did) in enumerate(chunk):
            codes[i] = np.asarray(docid_to_codes[did], np.int32)
        with torch.no_grad():
            s = model.rerank_score(*_on(model, ids, mask, codes))
        s = s.float().cpu().numpy()[:len(chunk)]
        for (qid, did), sc in zip(chunk, s):
            out.setdefault(qid, {})[did] = float(sc)
    return out


def load_bert_teacher(ckpt_dir: str, vocab_size: int,
                      geometry: Optional[Mapping] = None,
                      batch_compile: bool = True, device=None) -> ScoreFn:
    """Load a BertCrossEncoder teacher checkpoint (params.pt, or the JAX
    package's Orbax tree; saved by stage_train or converted with
    hf_bert_to_params) -> a float32 ScoreFn on ``device`` (default "cuda")
    for rerank_pairs. ``geometry``: BertCrossEncoder kwargs; defaults read
    from ``bert_geometry.json`` next to the checkpoint when present
    (reference loads the pretrained MiniLM teacher,
    modeling/cross_encoder.py:7-16). ``batch_compile`` is accepted and
    read by neither package (ROADMAP.md Queue 3)."""
    from ripor_tpu_torch.models.cross_encoder import BertCrossEncoder
    from ripor_tpu_torch.train.checkpoint import load_params

    device = resolve_device(device)
    geo = dict(geometry or {})
    geo_path = Path(ckpt_dir) / "bert_geometry.json"
    if not geo and geo_path.exists():
        geo = json.loads(geo_path.read_text())
    ce = BertCrossEncoder(vocab_size=vocab_size, device=device, **geo)
    ce.load_state_dict(load_params(ckpt_dir, model=ce))

    @torch.no_grad()
    def score(ids, mask):
        ids, mask = (torch.as_tensor(a).to(device) for a in (ids, mask))
        # token_type_ids re-derived from the first [SEP]: doc-segment
        # tokens (strictly after it, inside the row) get type 1, exactly
        # the BertBceCollator training convention (data/collators.py) and
        # the reference teacher's qd_kwargs (cross_encoder.py:17-23); a
        # row without [SEP] gives index 0, as jnp.argmax does
        sep = (ids == SEP_ID).int().argmax(dim=1)
        pos = torch.arange(ids.shape[1], device=device)
        types = ((pos[None, :] > sep[:, None]) & (mask == 1)).int()
        return ce(ids, mask, types).cpu().numpy().astype(np.float32)

    return score


def add_qrel_positives(run: Dict[str, Dict[str, float]],
                       qrel: Mapping[str, Mapping[str, int]],
                       boost: float = 1.0) -> Dict[str, Dict[str, float]]:
    """Force qrel positives to the top of each query's candidate list
    (reference add_qrel_to_rerank_run.py:16-46: positives get max score + 1)."""
    out = {}
    for qid, docs in run.items():
        docs = dict(docs)
        rel = qrel.get(qid, {})
        if rel:
            top = max(docs.values()) if docs else 0.0
            for did, r in rel.items():
                if r > 0:
                    docs[str(did)] = top + boost
        out[qid] = docs
    return out


def rerank_query_smtids(cfg, params, tok: TextTokenizer,
                        queries: Collection,
                        qid_to_smtids: Mapping[str, Sequence[str]],
                        batch_size: int = 64, max_length: int = 64,
                        dtype=None, device=None
                        ) -> Dict[str, Dict[str, float]]:
    """Score (query, smtid) pairs with the RIPOR model's own sequential
    dot-product (reference Reranker.query_to_smtid_reranking,
    tasks/reranker.py:94-123, which sums get_query_smtids_score over
    positions — the same quantity as RiporModel.rerank_score).
    Returns {qid: {smtid_str: score}}."""
    model = _ripor(cfg, params, dtype, device)
    pairs = [(str(q), s) for q, smtids in qid_to_smtids.items()
             for s in smtids]
    out: Dict[str, Dict[str, float]] = {}
    for st in range(0, len(pairs), batch_size):
        chunk = pairs[st:st + batch_size]
        pad = batch_size - len(chunk)
        texts = [queries[q] for q, _ in chunk] + [""] * pad
        ids, mask = tokenize_queries(tok, texts, max_length)
        codes = np.zeros((batch_size, cfg.M), np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        for i, (_, smtid) in enumerate(chunk):
            c = parse_smtid_str(smtid)
            codes[i, :len(c)] = c
            lengths[i] = len(c)  # prefix positions only enter the score
        with torch.no_grad():
            s = model.rerank_score_prefix(*_on(model, ids, mask, codes,
                                               lengths))
        s = s.float().cpu().numpy()[:len(chunk)]
        for (qid, smtid), sc in zip(chunk, s):
            out.setdefault(qid, {})[smtid] = float(sc)
    return out


def rerank_cond_prefix(cfg, params, tok: TextTokenizer,
                       queries: Collection, docs: Collection,
                       triples: Sequence[Tuple[str, str, Sequence[int]]],
                       batch_size: int = 64, max_length: int = 64,
                       dtype=None, device=None
                       ) -> Dict[str, Dict[str, float]]:
    """Prefix-conditioned dense scoring: score(q | smtid prefix, d) =
    <dense_rep(q, prefix), dense_rep(d)> (reference
    Reranker.cond_prev_smtid_t5seq_encoder_reranking, tasks/reranker.py:
    125-155, calling T5SeqPretrainEncoder.cond_prev_smtid_query_doc_score,
    t5_generative_retriever.py:672-706 — the phase-1 prefix stage's
    inference engine). triples: (qid, docid, prefix code list, all the same
    length). Returns {qid: {docid: score}}."""
    model = _ripor(cfg, params, dtype, device)
    plen = len(triples[0][2])
    if not all(len(t[2]) == plen for t in triples):
        raise ValueError("rerank_cond_prefix needs a uniform prefix length")
    out: Dict[str, Dict[str, float]] = {}
    for s in range(0, len(triples), batch_size):
        chunk = triples[s:s + batch_size]
        pad = batch_size - len(chunk)
        q_texts = [queries[q] for q, _, _ in chunk] + [""] * pad
        d_texts = [docs[d] for _, d, _ in chunk] + [""] * pad
        prefixes = np.asarray([list(p) for _, _, p in chunk]
                              + [[0] * plen] * pad, np.int32)
        q_ids, q_mask = tokenize_queries(tok, q_texts, max_length)
        d_ids, d_mask = tokenize_docs(tok, d_texts, max_length)
        q_ids, q_mask, prefixes, d_ids, d_mask = _on(
            model, q_ids, q_mask, prefixes, d_ids, d_mask)
        with torch.no_grad():
            q_rep = model.dense_rep(q_ids, q_mask, prefixes)
            d_rep = model.dense_rep(d_ids, d_mask)
        sc = (q_rep.float() * d_rep.float()).sum(-1).cpu().numpy()
        for (qid, did, _), v in zip(chunk, sc[:len(chunk)]):
            out.setdefault(str(qid), {})[str(did)] = float(v)
    return out
