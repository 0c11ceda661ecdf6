"""Okapi BM25 over a document collection — the first-stage lexical run; a
copy of ripor_tpu/evaluation/bm25.py (host-side numpy).

The reference never computes BM25 itself: its phase-1 distillation consumes
a prebuilt run artifact (``data/msmarco-full/bm25_run/qrel_added_qid_docids_
teacher_scores.train.json``, full_scripts/full_train_t5seq_encoder_0.sh:13)
produced offline with Anserini. A standalone framework must be able to
produce that artifact, so this module ships a small host-side BM25
(inverted index + numpy score accumulation — lexical indexing is host-side
preprocessing, not device compute, exactly like tokenization).

Defaults k1=0.9, b=0.4 are the standard MS MARCO Anserini settings the
reference's run was built with.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_WORD = re.compile(r"[a-z0-9]+")


def _terms(text: str) -> List[str]:
    return _WORD.findall(text.lower())


class BM25Index:
    """Inverted index over a doc collection; ``search`` scores one query,
    ``run`` produces the {qid: {docid: score}} trec-run dict every
    downstream stage consumes (same shape as reference run.json,
    evaluate.py:229-266)."""

    def __init__(self, doc_texts: Sequence[str], k1: float = 0.9,
                 b: float = 0.4):
        self.k1 = float(k1)
        self.b = float(b)
        self.n_docs = len(doc_texts)
        if self.n_docs == 0:
            raise ValueError("empty collection")
        lengths = np.zeros(self.n_docs, np.float32)
        post: Dict[str, Dict[int, int]] = {}
        for di, text in enumerate(doc_texts):
            terms = _terms(text)
            lengths[di] = len(terms)
            for t in terms:
                bucket = post.setdefault(t, {})
                bucket[di] = bucket.get(di, 0) + 1
        self.avgdl = float(lengths.mean()) or 1.0
        self._lengths = lengths
        # per-term: (doc indices, idf * saturated tf) precomputed — scoring
        # a query is then pure gather+add
        self._post: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for t, bucket in post.items():
            docs = np.fromiter(bucket.keys(), np.int64, len(bucket))
            tf = np.fromiter(bucket.values(), np.float32, len(bucket))
            df = len(bucket)
            idf = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
            denom = tf + self.k1 * (1.0 - self.b
                                    + self.b * lengths[docs] / self.avgdl)
            self._post[t] = (docs, idf * tf * (self.k1 + 1.0) / denom)

    def search(self, query: str, topk: int = 100
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores desc, doc indices) for docs with score > 0."""
        acc = np.zeros(self.n_docs, np.float32)
        for t in _terms(query):
            hit = self._post.get(t)
            if hit is not None:
                acc[hit[0]] += hit[1]
        k = min(topk, self.n_docs)
        idx = np.argpartition(-acc, k - 1)[:k]
        idx = idx[np.argsort(-acc[idx], kind="stable")]
        keep = acc[idx] > 0
        return acc[idx][keep], idx[keep]

    def run(self, query_ids: Sequence[str], query_texts: Sequence[str],
            docids: Sequence[str], topk: int = 100
            ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for qid, text in zip(query_ids, query_texts):
            scores, idx = self.search(text, topk)
            out[str(qid)] = {str(docids[d]): float(s)
                             for d, s in zip(idx, scores)}
        return out
