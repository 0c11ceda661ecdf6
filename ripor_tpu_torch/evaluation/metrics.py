"""trec-eval-compatible IR metrics (pure Python/numpy, no pytrec_eval).

A copy of ripor_tpu/evaluation/metrics.py: the port imports no ripor_tpu
module, since any of them loads jax.

Parity target: the reference's pytrec_eval usage (utils/metrics.py:18-104):
  mrr_k        — truncate run to top-k by score, then reciprocal rank
  recall_k     — trec_eval ``recall_k``: |rel ∩ top-k| / |rel|
  ndcg_cut_k   — graded nDCG with log2 discounts, ideal from qrel
Semantics matched exactly:
  * ranking sorts by (score desc, docid-string desc) — trec_eval's tie-break;
  * only queries present in BOTH run and qrel are evaluated (pytrec_eval
    default); aggregate = mean over evaluated queries;
  * relevant means rel > 0 for binary metrics; graded rel for nDCG.

run format: {qid: {docid: score}}; qrel: {qid: {docid: rel}} (same JSON
formats the reference reads/writes, evaluate.py:268-291).
"""
from __future__ import annotations

import json
import math
from typing import Dict, Mapping

Run = Mapping[str, Mapping[str, float]]
Qrel = Mapping[str, Mapping[str, int]]


def _ranked_docids(doc_scores: Mapping[str, float]) -> list:
    """trec_eval ordering: score descending, then docid string descending."""
    return [d for d, _ in sorted(doc_scores.items(),
                                 key=lambda kv: (kv[1], kv[0]), reverse=True)]


def truncate_run(run: Run, k: int) -> Dict[str, Dict[str, float]]:
    """Top-k by score per query (reference utils/metrics.py:9-15; Python
    sort is stable so score-ties keep dict insertion order, matched here)."""
    out = {}
    for qid, docs in run.items():
        ranked = sorted(docs.items(), key=lambda kv: kv[1], reverse=True)[:k]
        out[qid] = dict(ranked)
    return out


def _eval_queries(run: Run, qrel: Qrel):
    for qid in run:
        if qid in qrel:
            yield qid


def mrr_k(run: Run, qrel: Qrel, k: int = 10, agg: bool = True):
    """MRR with run truncated to top-k (reference utils/metrics.py:18-25)."""
    truncated = truncate_run(run, k)
    per_q = {}
    for qid in _eval_queries(truncated, qrel):
        rel = {d for d, r in qrel[qid].items() if r > 0}
        rr = 0.0
        for rank, d in enumerate(_ranked_docids(truncated[qid]), start=1):
            if d in rel:
                rr = 1.0 / rank
                break
        per_q[qid] = rr
    if not agg:
        return per_q
    return sum(per_q.values()) / max(1, len(per_q))


def recall_k(run: Run, qrel: Qrel, k: int = 10, agg: bool = True):
    """trec_eval recall_k (reference utils/metrics.py:27-38)."""
    per_q = {}
    for qid in _eval_queries(run, qrel):
        rel = {d for d, r in qrel[qid].items() if r > 0}
        if not rel:
            continue
        top = _ranked_docids(run[qid])[:k]
        per_q[qid] = len(rel.intersection(top)) / len(rel)
    if not agg:
        return per_q
    return sum(per_q.values()) / max(1, len(per_q))


def ndcg_cut_k(run: Run, qrel: Qrel, k: int = 10, agg: bool = True):
    """Graded nDCG@k, trec_eval ``ndcg_cut`` semantics: DCG = sum
    rel_i / log2(i + 1); ideal ranking from the full qrel."""
    per_q = {}
    for qid in _eval_queries(run, qrel):
        grades = qrel[qid]
        top = _ranked_docids(run[qid])[:k]
        dcg = sum(grades.get(d, 0) / math.log2(i + 2) for i, d in enumerate(top))
        ideal = sorted((r for r in grades.values() if r > 0), reverse=True)[:k]
        idcg = sum(r / math.log2(i + 2) for i, r in enumerate(ideal))
        per_q[qid] = dcg / idcg if idcg > 0 else 0.0
    if not agg:
        return per_q
    return sum(per_q.values()) / max(1, len(per_q))


METRIC_FNS = {"mrr": mrr_k, "recall": recall_k, "ndcg_cut": ndcg_cut_k}

# pytrec_eval's default cut grid for bare "recall"/"ndcg_cut" measures
TREC_CUTS = (5, 10, 15, 20, 30, 100, 200, 500, 1000)


def binarize_qrel(qrel: Qrel, threshold: int = 2) -> Dict[str, Dict[str, int]]:
    """TREC-DL convention: graded judgments binarized at rel >= threshold
    (2 by default) for binary metrics — the reference consumes pre-built
    ``qrel_binary.json`` files with exactly this split (arguments.py:163-169;
    utils/metrics.py:68-70 asserts binary qrels for recall/mrr on TREC)."""
    return {qid: {d: (1 if r >= threshold else 0) for d, r in docs.items()}
            for qid, docs in qrel.items()}


def evaluate_run(run: Run, qrel: Qrel, metric: str, use_native: bool = True):
    """'mrr_10' / 'recall_100' / 'ndcg_cut_10' style metric strings
    (reference load_and_evaluate, utils/metrics.py:63-79). Bare 'recall' /
    'ndcg_cut' (the reference's TREC-DL eval_metric entries,
    arguments.py:171-175) return the full pytrec_eval cut grid as a dict.
    Routes to the C++ evaluator (native/ripor_native.cc) for large runs."""
    if metric in ("recall", "ndcg_cut", "ndcg"):
        base = "ndcg_cut" if metric.startswith("ndcg") else "recall"
        return {f"{base}_{k}": evaluate_run(run, qrel, f"{base}_{k}",
                                            use_native=use_native)
                for k in TREC_CUTS}
    name, _, k = metric.rpartition("_")
    if name == "ndcg":
        name = "ndcg_cut"
    # the C++ path only wins on multi-million-result runs (the dict->array
    # encoding overhead dominates below that)
    if use_native and sum(len(v) for v in run.values()) > 1_000_000:
        from ripor_tpu_torch.native_ext import eval_metrics_native
        v = eval_metrics_native(run, qrel, name, int(k))
        if v is not None:
            return v
    return METRIC_FNS[name](run, qrel, int(k))


def load_and_evaluate(qrel_path: str, run_path: str, metric: str) -> Dict[str, float]:
    with open(qrel_path) as f:
        qrel = json.load(f)
    with open(run_path) as f:
        run = json.load(f)
    # TREC-DL pairing rule (reference utils/metrics.py:68-70): graded
    # qrel.json only feeds ndcg; binary metrics need qrel_binary.json
    if "TREC" in str(qrel_path):
        assert ("binary" not in str(qrel_path)) == metric.startswith("ndcg"), (
            "TREC qrels: use qrel_binary.json for binary metrics, "
            "qrel.json for ndcg")
    return {metric: evaluate_run(run, qrel, metric)}


def qrel_to_smtid_qrel(docid_to_smtid: Mapping[str, list], qrel: Qrel,
                       truncate: int = 0) -> Dict[str, Dict[str, int]]:
    """Map a docid-space qrel into smtid-string space (reference
    from_qrel_to_qsmtid_rel, utils/utils.py:103-135): each relevant docid
    contributes its smtid string 'c1_c2_...' with max relevance on collision."""
    out: Dict[str, Dict[str, int]] = {}
    for qid, docs in qrel.items():
        smtid_rel: Dict[str, int] = {}
        for docid, rel in docs.items():
            codes = docid_to_smtid[docid]
            if codes and codes[0] == -1:   # reference keeps the -1 sentinel
                codes = codes[1:]
            if truncate:
                codes = codes[:truncate]
            key = "_".join(str(c) for c in codes)
            smtid_rel[key] = max(smtid_rel.get(key, 0), rel)
        out[qid] = smtid_rel
    return out
