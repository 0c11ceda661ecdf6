"""Phase-3 data-generation flywheel — the device-side halves, in PyTorch.

Port of ripor_tpu/pipeline/flywheel.py (SURVEY.md §3.5):
  D^R: dense-teacher docids grouped by smtid prefix (datagen.group_docids_by_prefix)
  D^B: constrained beam search over PREFIX tries at lengths 4/8/16
       (evaluate.py:528-655 t5seq_aq_get_qid_to_smtid_rankdata) -> here
       ``beam_prefix_candidates``, on make_beam_search_fn's default path
       (megarow at even segment spans: kernels K1-K3 on the card);
  both sides cross-encoder-rescored per (query, prefix, docid)
       (evaluation/reranker.rerank_qid_smtid_docids), then decay-merged
       (datagen.merge_rankdata_with_decay).

Also ``create_trainset``: (run + teacher scores + qrel) -> the
{"qid","docids","scores"} JSONL format every MarginMSE phase trains on
(reference rerank_for_create_trainset, rerank.py:41-105).
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ripor_tpu_torch.data.datasets import smtid_to_str
from ripor_tpu_torch.data.tokenizer import TextTokenizer, tokenize_queries
from ripor_tpu_torch.decode.beam import (NEG_INF, make_beam_search_fn,
                                         resolve_device)
from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.ripor import RiporModel
from ripor_tpu_torch.pipeline.datagen import (attach_lng_knp_scores,
                                              group_docids_by_prefix,
                                              groups_to_rankdata,
                                              merge_rankdata_with_decay,
                                              prefix_smtid_strings,
                                              union_docid_groups)
from ripor_tpu_torch.trie.build import build_trie
from ripor_tpu_torch.trie.succinct import succinct_tables, tables_to_torch


def search_model(cfg: RiporConfig, params, dtype, device=None) -> RiporModel:
    """A RiporModel in ``dtype`` on ``device`` (default "cuda") for a
    search: ``params`` itself when it is a RiporModel of that dtype on
    that device, else a new model holding ``params`` (a state_dict, or a
    RiporModel's weights), which load_state_dict casts to the model's
    dtypes."""
    device = resolve_device(device)
    if isinstance(params, RiporModel):
        at = next(params.parameters()).device
        if (params.dtype == dtype and at.type == device.type
                and device.index in (None, at.index)):
            return params
        params = params.state_dict()
    model = RiporModel(cfg, dtype=dtype, device=device)
    model.load_state_dict(params)
    return model


def beam_prefix_candidates(cfg: RiporConfig, params, tok: TextTokenizer,
                           query_ids: Sequence[str],
                           query_texts: Sequence[str],
                           doc_codes: np.ndarray, docids: Sequence[str],
                           prefix_len: int, num_beams: int = 100,
                           batch_size: int = 4, max_length: int = 64,
                           max_docs_per_prefix: int = 100,
                           dtype=torch.bfloat16, device=None
                           ) -> Dict[str, Dict[str, List[str]]]:
    """D^B: beam-search the PREFIX trie (length ``prefix_len``) for each
    train query and expand every surviving prefix to its documents.
    Returns {qid: {prefix_smtid_str: [docids]}} ready for teacher rescoring
    (reference decode at beam 100, batch 4 — full_evaluate...sh:127-139).

    ``params``: a state_dict or a RiporModel; the search runs in ``dtype``
    (default bfloat16, as the JAX function) on ``device`` (default
    "cuda"), through make_beam_search_fn's default path. Queries go in
    batches of ``batch_size``, the last padded with empty queries; dead
    beams (NEG_INF score, or a state that reached no group) are dropped."""
    model = search_model(cfg, params, dtype, device)
    dev = next(model.parameters()).device
    trie = build_trie(np.ascontiguousarray(doc_codes[:, :prefix_len]), cfg.K)
    tables = tables_to_torch(succinct_tables(trie), dev)
    fn = make_beam_search_fn(cfg, num_beams, constrained=True,
                             max_steps=prefix_len, dtype=dtype, device=dev)
    out: Dict[str, Dict[str, List[str]]] = {}
    n = len(query_ids)
    for s in range(0, n, batch_size):
        texts = list(query_texts[s:s + batch_size])
        pad = batch_size - len(texts)
        ids, mask = tokenize_queries(tok, texts + [""] * pad, max_length)
        scores, codes, state = fn(model, ids, mask, tables)
        scores = scores.cpu().numpy()
        state = state.cpu().numpy()
        codes = codes.cpu().numpy()
        for bi in range(len(texts)):
            qid = str(query_ids[s + bi])
            bucket: Dict[str, List[str]] = {}
            for j in range(num_beams):
                if scores[bi, j] <= NEG_INF / 2 or state[bi, j] > -2:
                    continue
                g = -2 - state[bi, j]
                prefix = smtid_to_str(codes[bi, j])
                docs = trie.docids_of_group(int(g))[:max_docs_per_prefix]
                bucket[prefix] = [str(docids[d]) for d in docs]
            out[qid] = bucket
    return out


def datagen_round(cfg: RiporConfig, params, tok: TextTokenizer,
                  queries, qid_to_docids: Mapping[str, Sequence[str]],
                  doc_codes: np.ndarray, docids: Sequence[str],
                  score_pairs_fn, prefix_len: int, num_beams: int = 100,
                  batch_size: int = 4, decay: int = 2,
                  max_length: int = 64,
                  return_intermediates: bool = False, device=None):
    """One flywheel round at one prefix length: D^R grouping + D^B beam
    candidates (bfloat16 search on ``device``, default "cuda"), teacher
    rescoring of EVERY (q, prefix, doc) triple via ``score_pairs_fn``
    ([(qid, docid)] -> {qid: {docid: score}}), decay merge, and lng_knp
    score attachment for prefix_len > 4.

    The reference runs this as three chained scripts
    (t5seq_aq_get_qid_to_smtid_rankdata, evaluate.py:528-655;
    cross_encoder_rerank_for_qid_smtid_docids, rerank.py:587-654;
    get_lng_knp_qid_smtids_scores_jsonl_examples). Missing teacher scores
    raise — no 0.0 defaults (groups_to_rankdata).

    ``return_intermediates``: also return the RAW (undecayed) union
    rankdata and pair scores — inputs for the alternative example builders
    (merge_self_neg_sym_neg / qrel_first_examples, which apply their own
    decay; feeding them the merged output would double-decay)."""
    p_str = prefix_smtid_strings(doc_codes, docids, prefix_len)
    d_r = group_docids_by_prefix(qid_to_docids, p_str)
    d_b = beam_prefix_candidates(
        cfg, params, tok, list(qid_to_docids),
        [queries[q] for q in qid_to_docids], doc_codes, docids,
        prefix_len=prefix_len, num_beams=num_beams, batch_size=batch_size,
        max_length=max_length, device=device)
    union = union_docid_groups(d_r, d_b)
    pairs = sorted({(qid, d) for qid, bucket in union.items()
                    for docs in bucket.values() for d in docs})
    pair_scores = score_pairs_fn(pairs)
    merged = merge_rankdata_with_decay(
        groups_to_rankdata(d_r, pair_scores),
        groups_to_rankdata(d_b, pair_scores),
        max_new_token=prefix_len, decay=decay)
    if prefix_len > 4:
        merged = attach_lng_knp_scores(merged, prefix_len)
    if return_intermediates:
        return merged, groups_to_rankdata(union, pair_scores), pair_scores
    return merged


def create_trainset(run: Mapping[str, Mapping[str, float]],
                    qrel: Optional[Mapping[str, Mapping[str, int]]] = None,
                    top_k: int = 100) -> List[Dict]:
    """Teacher run -> MarginMSE trainset examples, positive first.

    With a qrel, the positive is a relevant doc (boosted to front, like
    add_qrel_to_rerank_run.py); otherwise the top-scored doc. Examples with
    < 2 candidates are dropped (no negative to sample)."""
    examples = []
    for qid, docs in run.items():
        ranked = sorted(docs.items(), key=lambda kv: kv[1], reverse=True)[:top_k]
        if qrel and qid in qrel:
            rel = {d for d, r in qrel[qid].items() if r > 0}
            pos = [p for p in ranked if p[0] in rel]
            neg = [p for p in ranked if p[0] not in rel]
            ranked = pos[:1] + neg if pos else ranked
        if len(ranked) < 2:
            continue
        examples.append({"qid": str(qid),
                         "docids": [d for d, _ in ranked],
                         "scores": [float(s) for _, s in ranked]})
    return examples


def write_jsonl(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def read_jsonl(path: str) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out
