"""Whether the timed path's answers are correct.

Every answer of the window is checked for its form: ``topk`` distinct
documents of the corpus with finite scores that do not rise. A sample of
the answered queries drawn from the seed, with the longest query in it,
is then held against the plain reference (reference/): for every
document of each sampled answer, the reference scores the document's
codes, teacher-forced, over the query's own tokens, in the precision the
configuration states, and
``score_gap`` is the widest distance between a score the program served
and the reference's score of the same document, ``score_gap_median`` the
median of those distances, and ``worst_median_gap`` the largest of the
sampled answers' own medians, which one wrong answer moves. A wrong cache, a wrong beam's history, a wrong
query's encoder states or a document the beams did not reach each move
them by far more than rounding does. The reference also runs its own
trie-constrained beam search over the same query (reference/trie.py
builds its trie from the corpus's codes), and ``beam_miss`` is the share
of its documents that the served answers lack: a search that keeps the
wrong beams misses many.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from portbench.reference import Reference, exact_float32, query_ids


def well_formed(result, topk: int, n_docs: int) -> bool:
    if len(result) != min(topk, n_docs):
        return False
    try:
        docs = [int(d) for d, _ in result]
    except ValueError:
        return False
    scores = [s for _, s in result]
    return (len(set(docs)) == len(docs)
            and all(0 <= d < n_docs for d in docs)
            and all(math.isfinite(s) for s in scores)
            and all(a >= b for a, b in zip(scores, scores[1:])))


def sample(answers, queries: List[str], count: int, seed: int) -> list:
    """``count`` answers drawn from the seed, the longest query's among
    them (answers: [(query index, result, ...)])."""
    if not answers:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 4])
    longest = max(range(len(answers)),
                  key=lambda i: len(queries[answers[i][0]].split()))
    rest = [i for i in range(len(answers)) if i != longest]
    pick = [longest] + list(rng.choice(rest, min(count - 1, len(rest)),
                                       replace=False))
    return [answers[i] for i in pick]


def compare(picked, queries, weights, dims: dict, codes: np.ndarray,
            runs, engine: dict, device, precision: str,
            control: bool = False) -> dict:
    """The picked answers against the reference computed in
    ``precision``, the configuration's: for every document of every
    answer, served score - reference score (``diff``; teacher-forced), and
    for every answer the documents of the reference's own beam search that
    the answer misses (``missing``, of ``found``). With ``control``, the
    same numbers for the reference in float8 put in the program's place:
    its scores of the same documents, and its own search's documents."""
    import torch
    quant = engine["kv_cache_quant"]
    ref = Reference(weights, dims, device, precision=precision, cache=quant)
    ids = [query_ids(queries[qi], dims["vocab_size"], engine["max_length"])
           for qi, *_ in picked]
    docs = [np.array([int(d) for d, _ in r]) for _, r, *_ in picked]
    uniq = [np.unique(codes[d], axis=0, return_inverse=True) for d in docs]
    paths = [torch.from_numpy(u) for u, _ in uniq]
    chunk = max(1, 2048 // engine["num_beams"])

    def run(model):
        encs = [model.encode(i) for i in ids]
        scores = [s.numpy()[inv.reshape(-1)] for s, (_, inv)
                  in zip(model.path_scores(encs, paths), uniq)]
        found = []
        for c in range(0, len(encs), chunk):
            found += model.search(encs[c:c + chunk], runs,
                                  engine["num_beams"], engine["topk"])
        return scores, found

    with exact_float32():
        want, truth = run(ref)
        if control:
            del ref
            got, docs = run(Reference(weights, dims, device, "float8",
                                      quant))
        else:
            got = [np.array([s for _, s in r], np.float64)
                   for _, r, *_ in picked]
    return {"diffs": [g - w for g, w in zip(got, want)],
            "missing": [len(set(t.tolist()) - set(d.tolist()))
                        for t, d in zip(truth, docs)],
            "found": [len(t) for t in truth],
            "truth": truth, "docs": docs}


def numbers(c: dict) -> Dict[str, float]:
    """The compared numbers: the widest and the median distance of a
    served score from the reference's, the largest of the answers' median
    distances, and the share of the reference's documents the answers
    miss."""
    if not c["found"]:
        return {"score_gap": None, "score_gap_median": None,
                "worst_median_gap": None, "beam_miss": None}
    gaps = np.abs(np.concatenate(c["diffs"]))
    return {"score_gap": float(gaps.max()),
            "score_gap_median": float(np.median(gaps)),
            "worst_median_gap": max(float(np.median(np.abs(d)))
                                    for d in c["diffs"]),
            "beam_miss": sum(c["missing"]) / max(1, sum(c["found"]))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] is not None and numbers[k] <= limits[k]
               for k in limits)
