"""Task-level rerank jobs — the reference ``rerank.py`` surface, in the
port.

Port of ripor_tpu/evaluation/rerank_tasks.py: the same tasks, shard stems,
``nranks`` check, round-robin sharding and JSON bytes.

The reference exposes 16 rerank tasks as 8 pairs: a DDP-sharded scoring pass
that writes per-rank JSON (task) plus a rank-0 merge that assembles the
final artifact and deletes the shards (task``_2``)
(reference t5_pretrainer/rerank.py:38-654). Here each pair is one
scoring function taking ``rank/nranks`` plus one ``*_merge`` function,
over the model-agnostic engines in
:mod:`ripor_tpu_torch.evaluation.reranker`. Output artifact names and JSON
shapes match the reference byte-for-byte so downstream stages (and
reference-produced artifacts) interoperate.

Sharding is round-robin by query index (``i % nranks == rank``), the
reference's own scheme for the prefix tasks (rerank.py:408,514,598); ranks
can run as separate processes/hosts or sequentially in one.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ripor_tpu_torch.data.datasets import Collection, smtid_to_str
from ripor_tpu_torch.data.tokenizer import TextTokenizer
from ripor_tpu_torch.evaluation.metrics import mrr_k, qrel_to_smtid_qrel
from ripor_tpu_torch.evaluation.reranker import (
    ScoreFn,
    rerank_pairs,
    rerank_qid_smtid_docids,
    rerank_query_smtids,
)


def _write(path: Path, obj) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def _rank_files(out_dir: str, stem: str,
                nranks: Optional[int] = None) -> List[Path]:
    """Shard files ``{stem}_<rank>.json`` (exact stem — "rerank" must not
    swallow "rerank_teacher_0.json"). When ``nranks`` is given, every rank
    0..nranks-1 must be present — a shard lost to a dead worker must fail
    the merge, not silently drop that rank's queries (cmd_retrieve_merge
    enforces the same)."""
    out = Path(out_dir)
    def is_shard(p: Path) -> bool:
        if not (p.name.startswith(stem + "_") and p.suffix == ".json"):
            return False
        tail = p.name[len(stem) + 1:-len(".json")]
        return tail.isdigit()
    files = sorted(p for p in out.iterdir() if is_shard(p))
    if nranks is not None:
        have = {int(p.name[len(stem) + 1:-len(".json")]) for p in files}
        missing = sorted(set(range(nranks)) - have)
        if missing:
            raise FileNotFoundError(
                f"missing {stem}_<rank>.json shards for ranks {missing} "
                f"in {out_dir} (expected ranks 0..{nranks - 1})")
    return files


def _merge_flat(out_dir: str, stem: str, remove: bool = True,
                nranks: Optional[int] = None
                ) -> Dict[str, Dict[str, float]]:
    """Update-merge per-rank {qid: {key: score}} shards
    (rerank.py:72-85 pattern)."""
    merged: Dict[str, Dict[str, float]] = {}
    files = _rank_files(out_dir, stem, nranks)
    if not files:
        raise FileNotFoundError(f"no {stem}_*.json shards in {out_dir}")
    for p in files:
        with open(p) as f:
            sub = json.load(f)
        for qid, rankdata in sub.items():
            merged.setdefault(qid, {}).update(rankdata)
    if remove:
        for p in files:
            os.remove(p)
    return merged


def _merge_nested(out_dir: str, stem: str, remove: bool = True,
                  nranks: Optional[int] = None
                  ) -> Dict[str, Dict[str, List[List]]]:
    """Concat-merge per-rank {qid: {smtid: [[docid, score], ...]}} shards
    (rerank.py:450-464 pattern), re-sorted by score desc."""
    merged: Dict[str, Dict[str, List[List]]] = {}
    files = _rank_files(out_dir, stem, nranks)
    if not files:
        raise FileNotFoundError(f"no {stem}_*.json shards in {out_dir}")
    for p in files:
        with open(p) as f:
            sub = json.load(f)
        for qid, smtid_map in sub.items():
            dst = merged.setdefault(qid, {})
            for smtid, rows in smtid_map.items():
                dst.setdefault(smtid, []).extend(rows)
    for qid in merged:
        for smtid in merged[qid]:
            merged[qid][smtid].sort(key=lambda x: -x[1])
    if remove:
        for p in files:
            os.remove(p)
    return merged


def _shard_keys(keys: Sequence[str], rank: int, nranks: int) -> List[str]:
    return [k for i, k in enumerate(keys) if i % nranks == rank]


# ---------------------------------------------------------------- 1. trainset
def rerank_for_create_trainset(score_fn: ScoreFn, tok: TextTokenizer,
                               queries: Collection, docs: Collection,
                               run: Mapping[str, Mapping[str, float]],
                               out_dir: str, rank: int = 0, nranks: int = 1,
                               batch_size: int = 64, max_length: int = 256
                               ) -> str:
    """Teacher-score a retrieval run's (qid, docid) pairs -> rerank_{rank}.json
    (reference rerank_for_create_trainset, rerank.py:41-66 +
    Reranker.reranking name=local_rank, tasks/reranker.py:49-52)."""
    qids = _shard_keys(sorted(run), rank, nranks)
    pairs = [(q, d) for q in qids for d in run[q]]
    scored = rerank_pairs(score_fn, tok, queries, docs, pairs,
                          batch_size, max_length)
    return _write(Path(out_dir) / f"rerank_{rank}.json", scored)


def rerank_for_create_trainset_merge(out_dir: str, topk: int = 200,
                                     nranks: Optional[int] = None) -> str:
    """Merge rank shards -> qid_docids_teacher_scores.train.json JSONL with
    per-query top-``topk`` docs sorted by teacher score (reference
    rerank_for_create_trainset_2, rerank.py:67-113)."""
    merged = _merge_flat(out_dir, "rerank", nranks=nranks)
    out = Path(out_dir) / "qid_docids_teacher_scores.train.json"
    with open(out, "w") as f:
        for qid, rankdata in merged.items():
            ranked = sorted(rankdata.items(), key=lambda kv: -kv[1])[:topk]
            f.write(json.dumps({"qid": qid,
                                "docids": [d for d, _ in ranked],
                                "scores": [s for _, s in ranked]}) + "\n")
    return str(out)


def rerank_for_evaluate_merge(out_dir: str,
                              nranks: Optional[int] = None) -> str:
    """Merge rank shards -> qid_to_rerank_data.json (reference
    rerank_for_evaluate_2, rerank.py:114-158: same merge, run-style output
    for trec evaluation instead of a trainset)."""
    merged = _merge_flat(out_dir, "rerank", nranks=nranks)
    return _write(Path(out_dir) / "qid_to_rerank_data.json", merged)


# ------------------------------------------------------- 2. pseudo queries
def assign_scores_for_pseudo_queries(score_fn: ScoreFn, tok: TextTokenizer,
                                     pseudo_queries: Collection,
                                     docs: Collection,
                                     docid_pseudo_qids: Mapping[str, Sequence[str]],
                                     out_dir: str, rank: int = 0,
                                     nranks: int = 1, batch_size: int = 64,
                                     max_length: int = 256) -> str:
    """Teacher-score (doc, pseudo-query) pairs -> pid_qids_rerank_scores_
    {rank}.json of {pid: {qid: score}} (reference
    assign_scores_for_pseudo_queries, rerank.py:159-180)."""
    pids = _shard_keys(sorted(docid_pseudo_qids), rank, nranks)
    pairs = [(qid, pid) for pid in pids for qid in docid_pseudo_qids[pid]]
    scored = rerank_pairs(score_fn, tok, pseudo_queries, docs, pairs,
                          batch_size, max_length)
    pid_to_qids: Dict[str, Dict[str, float]] = {}
    for qid, docmap in scored.items():
        for pid, s in docmap.items():
            pid_to_qids.setdefault(pid, {})[qid] = s
    return _write(Path(out_dir) / f"pid_qids_rerank_scores_{rank}.json",
                  pid_to_qids)


def assign_scores_for_pseudo_queries_merge(out_dir: str,
                                           nranks: Optional[int] = None
                                           ) -> str:
    """rerank.py:181-202."""
    merged = _merge_flat(out_dir, "pid_qids_rerank_scores", nranks=nranks)
    return _write(Path(out_dir) / "pid_qids_rerank_scores.json", merged)


# ---------------------------------------- 3. self-rerank qid -> smtid (model)
def query_to_docid_rerank_for_qid_smtids(cfg, params, tok: TextTokenizer,
                                         queries: Collection,
                                         qid_docids: Mapping[str, Sequence[str]],
                                         docid_to_smtid: Mapping[str, Sequence[int]],
                                         out_dir: str, rank: int = 0,
                                         nranks: int = 1,
                                         batch_size: int = 64,
                                         max_length: int = 64,
                                         device=None) -> str:
    """Score each query's candidate docids' FULL smtids with the RIPOR
    model's own sequential dot product -> qid_smtids_rerank_{rank}.json
    (reference query_to_docid_rerank_for_qid_smtids, rerank.py:203-256 +
    Reranker.query_to_smtid_reranking, tasks/reranker.py:94-123).
    ``params``: the model's state_dict; it runs in bfloat16 on ``device``
    (default "cuda")."""
    qids = _shard_keys(sorted(qid_docids), rank, nranks)
    qid_to_smtids = {
        q: sorted({smtid_to_str(docid_to_smtid[d]) for d in qid_docids[q]})
        for q in qids}
    scored = rerank_query_smtids(cfg, params, tok, queries, qid_to_smtids,
                                 batch_size, max_length, device=device)
    return _write(Path(out_dir) / f"qid_smtids_rerank_{rank}.json", scored)


def query_to_docid_rerank_for_qid_smtids_merge(
        out_dir: str, docid_to_smtid: Mapping[str, Sequence[int]],
        qrel: Optional[Mapping[str, Mapping[str, int]]] = None,
        nranks: Optional[int] = None) -> Tuple[str, Dict[str, float]]:
    """Merge -> qid_smtids_rerank.json; when a qrel is given also write
    metric.json with smtid-level MRR@10/@100 (reference
    query_to_docid_rerank_for_qid_smtids_2, rerank.py:257-312)."""
    merged = _merge_flat(out_dir, "qid_smtids_rerank", nranks=nranks)
    path = _write(Path(out_dir) / "qid_smtids_rerank.json", merged)
    metrics: Dict[str, float] = {}
    if qrel is not None:
        smtid_qrel = qrel_to_smtid_qrel(docid_to_smtid, qrel)
        metrics = {"mrr_at_10": mrr_k(merged, smtid_qrel, k=10),
                   "mrr_at_100": mrr_k(merged, smtid_qrel, k=100)}
        _write(Path(out_dir) / "metric.json", metrics)
    return path, metrics


# ------------------------------------------- 4. teacher rerank qid -> smtid
def teacher_rerank_for_qid_smtids(score_fn: ScoreFn, tok: TextTokenizer,
                                  queries: Collection, docs: Collection,
                                  qid_smtid_rank: Mapping[str, Mapping[str, float]],
                                  docid_to_smtid: Mapping[str, Sequence[int]],
                                  out_dir: str, rank: int = 0,
                                  nranks: int = 1, batch_size: int = 64,
                                  max_length: int = 256) -> str:
    """Expand each retrieved smtid back to its docids and teacher-score the
    (query, docid) pairs -> rerank_teacher_{rank}.json (reference
    teacher_rerank_for_qid_smtids, rerank.py:313-338 via
    TeacherRerankFromQidSmtidsDataset)."""
    smtid_to_docids: Dict[str, List[str]] = {}
    for did, codes in docid_to_smtid.items():
        smtid_to_docids.setdefault(smtid_to_str(codes), []).append(did)
    qids = _shard_keys(sorted(qid_smtid_rank), rank, nranks)
    pairs = [(q, d) for q in qids for s in qid_smtid_rank[q]
             for d in smtid_to_docids.get(s, ())]
    scored = rerank_pairs(score_fn, tok, queries, docs, pairs,
                          batch_size, max_length)
    return _write(Path(out_dir) / f"rerank_teacher_{rank}.json", scored)


def teacher_rerank_for_qid_smtids_merge(out_dir: str,
                                        nranks: Optional[int] = None) -> str:
    """rerank.py:339-367."""
    merged = _merge_flat(out_dir, "rerank_teacher", nranks=nranks)
    return _write(Path(out_dir) / "rerank_teacher.json", merged)


# --------------------------------------- 5. same-prefix docid pools (teacher)
def cross_encoder_rerank_for_same_prefix_docid(
        score_fn: ScoreFn, tok: TextTokenizer, queries: Collection,
        docs: Collection, docid_to_smtid: Mapping[str, Sequence[int]],
        train_qrel: Mapping[str, Mapping[str, int]], out_dir: str,
        rank: int = 0, nranks: int = 1, neg_sample: int = 50,
        batch_size: int = 64, max_length: int = 256, seed: int = 0) -> str:
    """For each train query, teacher-score a sample of the docids sharing
    each rel-doc's full smtid (prefix-collision pool) ->
    qid_to_smtid_to_rerank_{rank}.json of {qid: {smtid: [[docid, score]]}}
    (reference cross_encoder_rerank_for_same_prefix_docid,
    rerank.py:368-443)."""
    smtid_to_docids: Dict[str, List[str]] = {}
    for did, codes in docid_to_smtid.items():
        smtid_to_docids.setdefault(smtid_to_str(codes), []).append(did)
    rng = np.random.default_rng(seed + rank)
    qid_to_smtid_to_docids: Dict[str, Dict[str, List[str]]] = {}
    for i, qid in enumerate(sorted(train_qrel)):
        if i % nranks != rank:
            continue
        for reldocid, rel in train_qrel[qid].items():
            if rel <= 0 or reldocid not in docid_to_smtid:
                continue
            smtid = smtid_to_str(docid_to_smtid[reldocid])
            pool = smtid_to_docids[smtid]
            k = min(neg_sample, len(pool))
            sampled = list(rng.choice(pool, size=k, replace=False))
            qid_to_smtid_to_docids.setdefault(qid, {})[smtid] = sampled
    rankdata = rerank_qid_smtid_docids(score_fn, tok, queries, docs,
                                       qid_to_smtid_to_docids,
                                       batch_size, max_length)
    return _write(Path(out_dir) / f"qid_to_smtid_to_rerank_{rank}.json",
                  rankdata)


def cross_encoder_rerank_for_same_prefix_docid_merge(
        out_dir: str, nranks: Optional[int] = None) -> Tuple[str, str]:
    """Merge -> qid_to_smtid_to_rerank.json + the (identically-valued)
    qid_to_smtid_to_sampled_rerank.json the curriculum consumes (reference
    cross_encoder_rerank_for_same_prefix_docid_2, rerank.py:444-498 — its
    sub-sampling branch is commented out upstream)."""
    merged = _merge_nested(out_dir, "qid_to_smtid_to_rerank",
                           nranks=nranks)
    a = _write(Path(out_dir) / "qid_to_smtid_to_rerank.json", merged)
    b = _write(Path(out_dir) / "qid_to_smtid_to_sampled_rerank.json", merged)
    return a, b


# ------------------------------------ 6. hard negatives for same rel docid
def cross_encoder_rerank_for_same_reldocid_hard_docids(
        score_fn: ScoreFn, tok: TextTokenizer, queries: Collection,
        docs: Collection,
        qid_to_reldocid_hard_docids: Mapping[str, Mapping[str, Sequence[str]]],
        out_dir: str, rank: int = 0, nranks: int = 1,
        batch_size: int = 64, max_length: int = 256) -> str:
    """Teacher-score prepared hard-negative pools {qid: {reldocid: [docids]}}
    -> qid_to_reldocid_to_hard_rerank_{rank}.json (reference
    cross_encoder_rerank_for_same_reldocid_hard_docids, rerank.py:499-533)."""
    qids = _shard_keys(sorted(qid_to_reldocid_hard_docids), rank, nranks)
    sampled = {q: qid_to_reldocid_hard_docids[q] for q in qids}
    rankdata = rerank_qid_smtid_docids(score_fn, tok, queries, docs,
                                       sampled, batch_size, max_length)
    return _write(
        Path(out_dir) / f"qid_to_reldocid_to_hard_rerank_{rank}.json",
        rankdata)


def cross_encoder_rerank_for_same_reldocid_hard_docids_merge(
        out_dir: str, nranks: Optional[int] = None) -> str:
    """rerank.py:534-586."""
    merged = _merge_nested(out_dir, "qid_to_reldocid_to_hard_rerank",
                           nranks=nranks)
    return _write(Path(out_dir) / "qid_to_reldocid_to_hard_rerank.json",
                  merged)


# ------------------------------------------ 7. flywheel qid/smtid/docid
def cross_encoder_rerank_for_qid_smtid_docids(
        score_fn: ScoreFn, tok: TextTokenizer, queries: Collection,
        docs: Collection, qid_smtid_docids_path: str, rank: int = 0,
        nranks: int = 1, batch_size: int = 64, max_length: int = 256) -> str:
    """Teacher-rescore the flywheel's {qid: {smtid: [docids]}} artifact ->
    <stem>_teacher_score_{rank}.train.json next to the input (reference
    cross_encoder_rerank_for_qid_smtid_docids, rerank.py:587-624; the
    datagen pipeline calls the same engine in-process,
    pipeline/flywheel.py)."""
    with open(qid_smtid_docids_path) as f:
        qid_to_smtid_to_docids = json.load(f)
    qids = _shard_keys(sorted(qid_to_smtid_to_docids), rank, nranks)
    sampled = {q: qid_to_smtid_to_docids[q] for q in qids}
    rankdata = rerank_qid_smtid_docids(score_fn, tok, queries, docs,
                                       sampled, batch_size, max_length)
    # stem from the FILENAME only — a dot in a directory component must
    # not truncate the path
    src = Path(qid_smtid_docids_path)
    stem = src.name.split(".")[0]
    return _write(src.parent / f"{stem}_teacher_score_{rank}.train.json",
                  rankdata)


def cross_encoder_rerank_for_qid_smtid_docids_merge(
        out_dir: str, nranks: Optional[int] = None) -> str:
    """Merge -> qid_smtid_docids_teacher_score.train.json (reference
    rerank.py:625-654)."""
    out = Path(out_dir)
    files = sorted(p for p in out.iterdir()
                   if "_teacher_score_" in p.name
                   and p.name.endswith(".train.json")
                   and p.name != "qid_smtid_docids_teacher_score.train.json")
    if not files:
        raise FileNotFoundError(
            f"no *_teacher_score_<rank>.train.json shards in {out_dir}")
    if nranks is not None:
        have = {int(p.name.rsplit("_teacher_score_", 1)[1].split(".")[0])
                for p in files}
        missing = sorted(set(range(nranks)) - have)
        if missing:
            raise FileNotFoundError(
                f"missing _teacher_score_<rank> shards for ranks {missing} "
                f"in {out_dir} (expected ranks 0..{nranks - 1})")
    merged: Dict[str, Dict[str, List[List]]] = {}
    for p in files:
        with open(p) as f:
            sub = json.load(f)
        for qid, smtid_map in sub.items():
            dst = merged.setdefault(qid, {})
            for smtid, rows in smtid_map.items():
                dst.setdefault(smtid, []).extend(rows)
    for p in files:
        os.remove(p)
    return _write(out / "qid_smtid_docids_teacher_score.train.json", merged)
