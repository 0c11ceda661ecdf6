"""Run assembly for retrieval results.

Of ripor_tpu/evaluation/retriever.py only ``retrieve_to_run`` is ported
so far (a copy); the dense retrieval functions wait for their slice
(ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def retrieve_to_run(query_ids: list, docids: list, scores: np.ndarray,
                    indices: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Assemble a trec run dict {qid: {docid: score}} (reference
    DenseRetriever.retrieve writes run.json, tasks/evaluator.py:707-731)."""
    run = {}
    for qi, qid in enumerate(query_ids):
        run[str(qid)] = {str(docids[int(d)]): float(s)
                         for s, d in zip(scores[qi], indices[qi])}
    return run
