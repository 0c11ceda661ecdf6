"""Phase-3 training-data flywheel: prefix grouping, decay-weighted merge,
prefix-score attachment; a copy of ripor_tpu/pipeline/datagen.py
(host-side numpy). Pure-artifact glue with EXACT reference semantics
(SURVEY.md §3.5 calls this the easiest place to go silently wrong).

Reference scripts mirrored:
  * get_qid_smtid_docids_from_teacher_rerank_data.py:5-52  -> group_docids_by_prefix
  * get_qid_smtids_scores_jsonl_examples.py:9-16,42-113    -> DECAY_TO_FACTOR,
    merge_rankdata_with_decay (D^R ∪ D^B, per-prefix max * factor, top-100)
  * fully_create_lng_knp_examples_from_original_examples.py:6-33
                                                           -> attach_lng_knp_scores
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

# geometric decay factors per prefix length (reference :9-16). decay=2 is
# the published configuration (w_4=1/2, w_8=3/4, w_16=7/8, w_32=1).
DECAY_TO_FACTOR: Dict[int, Dict[int, float]] = {
    1: {4: 4. / 32, 8: 4. / 32 + 8. / 32, 16: 4. / 32 + 8. / 32 + 16. / 32},
    2: {4: 1. / 2, 8: 1. / 2 + 0.25, 16: 1. / 2 + 0.25 + 0.125, 32: 1.},
    8: {4: 0.8, 8: 0.8 + 0.2 * 0.8,
        16: 0.8 + 0.2 * 0.8 + (1 - 0.8 - 0.2 * 0.8) * 0.8, 32: 1.},
}

# per-loss prefix-score factors (reference lng_knp script :7-10): the ratio
# of the prefix factor to the example's own (max_new_token) factor
MNT_TO_SMTID_FACTOR: Dict[int, Dict[str, float]] = {
    32: {"smtid_4": 0.5, "smtid_8": 0.75, "smtid_16": 0.875},
    16: {"smtid_4": 0.5 / 0.875, "smtid_8": 0.75 / 0.875},
    8: {"smtid_4": 0.5 / 0.75},
}


def group_docids_by_prefix(qid_to_docids: Mapping[str, Sequence[str]],
                           docid_to_smtid_str: Mapping[str, str]
                           ) -> Dict[str, Dict[str, List[str]]]:
    """{qid: [docids]} + docid->prefix-smtid-string -> {qid: {smtid: [docids]}}
    (the D^R dense-teacher grouping)."""
    out: Dict[str, Dict[str, List[str]]] = {}
    for qid, docids in qid_to_docids.items():
        smtid_map: Dict[str, List[str]] = {}
        for docid in docids:
            smtid = docid_to_smtid_str[str(docid)]
            smtid_map.setdefault(smtid, []).append(str(docid))
        out[str(qid)] = smtid_map
    return out


def prefix_smtid_strings(codes: np.ndarray, docids: Sequence[str],
                         prefix_len: int) -> Dict[str, str]:
    """docid -> 'c1_..._cp' prefix string (reference truncation :17-22)."""
    return {str(d): "_".join(str(int(c)) for c in row[:prefix_len])
            for d, row in zip(docids, codes)}


def union_docid_groups(*group_maps: Mapping[str, Mapping[str, Sequence[str]]]
                       ) -> Dict[str, Dict[str, List[str]]]:
    """Union D^R and D^B {qid: {smtid: [docids]}} groupings (order-preserving
    dedup) into one map covering every (q, prefix, doc) triple the teacher
    must score (reference scores the merged qid_smtid_docids in one pass,
    rerank.py:587-654)."""
    out: Dict[str, Dict[str, List[str]]] = {}
    for groups in group_maps:
        for qid, bucket in groups.items():
            dst = out.setdefault(str(qid), {})
            for smtid, docs in bucket.items():
                cur = dst.setdefault(smtid, [])
                seen = set(cur)
                for d in docs:
                    if str(d) not in seen:
                        cur.append(str(d))
                        seen.add(str(d))
    return out


def groups_to_rankdata(groups: Mapping[str, Mapping[str, Sequence[str]]],
                       pair_scores: Mapping[str, Mapping[str, float]]
                       ) -> Dict[str, Dict[str, List[List]]]:
    """Attach teacher pair scores to a docid grouping -> rankdata
    {qid: {smtid: [[docid, score], ...]}} sorted by score desc.

    Every (qid, docid) MUST carry a real teacher score — a missing score
    raises (no silent 0.0 default: zero-scored docs would corrupt the decay
    merge's max-per-prefix semantics; reference rescoreds every triple,
    rerank.py:587-654)."""
    out: Dict[str, Dict[str, List[List]]] = {}
    for qid, bucket in groups.items():
        q_scores = pair_scores.get(str(qid))
        if q_scores is None:
            raise KeyError(f"no teacher scores for qid {qid}")
        out[str(qid)] = {}
        for smtid, docs in bucket.items():
            try:
                pairs = [[str(d), float(q_scores[str(d)])] for d in docs]
            except KeyError as e:
                raise KeyError(
                    f"missing teacher score for (qid={qid}, docid={e})") from e
            pairs.sort(key=lambda x: -x[1])
            out[str(qid)][smtid] = pairs
    return out


RankData = Mapping[str, Mapping[str, Sequence[Sequence]]]  # qid->smtid->[(docid,score)]


def _smtid_scores(rankdata_for_qid: Mapping[str, Sequence[Sequence]],
                  factor: float) -> Dict[str, float]:
    return {smtid: max(x[1] for x in pairs) * factor
            for smtid, pairs in rankdata_for_qid.items()}


def merge_rankdata_with_decay(original: RankData, self_data: RankData,
                              max_new_token: int, decay: int = 2,
                              keep_top: int = 100) -> List[Dict]:
    """D^R (dense-teacher) ∪ D^B (self beam-search) merge (reference
    :42-113): per-smtid score = max over (docid, score) pairs * decay factor;
    D^R truncated to top-100 BEFORE the union (exactly as the reference —
    self-data smtids join afterwards and can exceed 100); collisions keep
    the max; output examples sorted by score desc."""
    factor = DECAY_TO_FACTOR[decay][max_new_token]
    merged: Dict[str, Dict[str, float]] = {}
    for qid, rd in original.items():
        scores = _smtid_scores(rd, factor)
        if keep_top:
            scores = dict(sorted(scores.items(), key=lambda x: x[1],
                                 reverse=True)[:keep_top])
        merged[qid] = scores
    for qid, rd in self_data.items():
        scores = _smtid_scores(rd, factor)
        bucket = merged.setdefault(qid, {})
        for smtid, s in scores.items():
            bucket[smtid] = max(s, bucket[smtid]) if smtid in bucket else s
    examples = []
    for qid, smtid_to_score in merged.items():
        pairs = sorted(smtid_to_score.items(), key=lambda x: x[1], reverse=True)
        examples.append({"qid": qid,
                         "smtids": [p[0] for p in pairs],
                         "scores": [p[1] for p in pairs]})
    return examples


def attach_lng_knp_scores(examples: Iterable[Dict], max_new_token: int
                          ) -> List[Dict]:
    """Attach smtid_{4,8,16}_scores = scores * factor (reference :26-33)."""
    factors = MNT_TO_SMTID_FACTOR[max_new_token]
    out = []
    for ex in examples:
        ex = dict(ex)
        for name, f in factors.items():
            ex[f"{name}_scores"] = [s * f for s in ex["scores"]]
        out.append(ex)
    return out


def rankdata_to_docid_groups(rankdata: RankData
                             ) -> Dict[str, Dict[str, List[str]]]:
    """{qid: {smtid: [(docid, score)]}} -> {qid: {smtid: [docids]}}
    (reference argparse_from_qid_smtid_rank_to_qid_smtid_docids.py)."""
    return {qid: {smtid: [str(p[0]) for p in pairs]
                  for smtid, pairs in rd.items()}
            for qid, rd in rankdata.items()}


def expand_prefix_rankdata(rankdata_16: RankData,
                           docid_to_smtid_str_32: Mapping[str, str]
                           ) -> Dict[str, Dict[str, List]]:
    """Prefix-16 -> prefix-32 expansion (reference
    expand_smtid_for_qid_smtid_docids.py:35-85): each (docid, score) moves
    under the docid's full-length smtid, keeping the teacher score."""
    out: Dict[str, Dict[str, List]] = {}
    for qid, rd in rankdata_16.items():
        bucket: Dict[str, List] = {}
        for _, pairs in rd.items():
            for docid, score in pairs:
                full = docid_to_smtid_str_32[str(docid)]
                bucket.setdefault(full, []).append([docid, score])
        out[qid] = bucket
    return out


def pseudo_query_examples(docid_to_rankdata: Mapping[str, Mapping[str, float]],
                          qid_to_query: Mapping[str, str],
                          score_threshold: float = 1.0):
    """(docid -> {pseudo_qid: teacher score}, qid -> query text) ->
    (all, filtered) seq2seq examples {"docid","query"}; filtered keeps
    score > threshold (reference create_pseudo_query_to_docid_map.py:18-27,
    producing query_to_docid.train{,.filtered}.json for phase-2)."""
    all_ex, filtered = [], []
    for docid, rankdata in docid_to_rankdata.items():
        for qid, score in rankdata.items():
            ex = {"docid": str(docid), "query": qid_to_query[str(qid)]}
            all_ex.append(ex)
            if score > score_threshold:
                filtered.append(ex)
    return all_ex, filtered


def build_bce_examples(qrel: Mapping[str, Mapping[str, int]],
                       run: Mapping[str, Mapping[str, float]],
                       neg_sample: int = 50,
                       rng: Optional[np.random.Generator] = None
                       ) -> List[tuple]:
    """Pointwise BCE training triples (qid, docid, label) for the T5Seq
    cross-encoder: per qrel positive, `neg_sample` negatives drawn from the
    query's run, interleaved 1/0 then shuffled (reference
    build_bce_example_for_t5seq_encoder.py:55-70)."""
    rng = rng or np.random.default_rng(4680)
    examples = []
    for qid, rels in qrel.items():
        cand = list(run[str(qid)].keys())
        for rel_docid in rels:
            k = min(neg_sample, len(cand))
            negs = [cand[i] for i in rng.choice(len(cand), size=k,
                                                replace=False)]
            for neg in negs:
                examples.append((str(qid), str(rel_docid), 1))
                examples.append((str(qid), str(neg), 0))
    order = rng.permutation(len(examples))
    return [examples[i] for i in order]


def teacher_run_to_examples(run_scores: Mapping[str, Mapping[str, float]],
                            top_k: int = 200) -> List[Dict]:
    """Teacher-rescored run -> score-sorted docid trainset rows
    {"qid","docids","scores"} truncated at ``top_k`` (reference
    rerank_for_create_trainset_2, rerank.py:67-105: sort desc, cut at 200).
    These rows are NOT yet qrel-anchored — chain through
    :func:`qrel_added_teacher_examples`."""
    out = []
    for qid, docs in run_scores.items():
        ranked = sorted(docs.items(), key=lambda kv: kv[1],
                        reverse=True)[:top_k]
        out.append({"qid": str(qid),
                    "docids": [d for d, _ in ranked],
                    "scores": [float(s) for _, s in ranked]})
    return out


def qrel_added_teacher_examples(
        examples: Iterable[Dict],
        qid_to_reldocid_to_score: Mapping[str, Mapping[str, float]]
        ) -> List[Dict]:
    """add_qrel_to_rerank_run.py:13-37 semantics, exactly: ONE output row
    per (qid, rel docid). If the rel docid is absent from the teacher-scored
    candidate list it is PREPENDED with its own teacher score; if present,
    the row keeps the teacher ranking untouched (the trained "positive" is
    then the teacher's top doc, i.e. pure distillation — reference
    MarginMSEforPretrainDataset takes positive = docids[0],
    dataset/dataset.py:645-647). Queries with no qrel entry are dropped,
    as in the reference (it indexes qid_to_reldocid_to_score[qid])."""
    out = []
    for ex in examples:
        qid = str(ex["qid"])
        rels = qid_to_reldocid_to_score.get(qid)
        if not rels:
            continue
        in_list = set(ex["docids"])
        for reldocid, score in rels.items():
            if str(reldocid) in in_list:
                out.append({"qid": qid, "docids": list(ex["docids"]),
                            "scores": list(ex["scores"])})
            else:
                out.append({"qid": qid,
                            "docids": [str(reldocid)] + list(ex["docids"]),
                            "scores": [float(score)] + list(ex["scores"])})
    return out


def nway_labels(nway: int) -> List[float]:
    """Rank-bucket label template: [1, 1/2 .. 1/5, 0 x5, -0.5 x(nway-10)]
    (reference create_nway_dataset_from_score_dataset.py:21-26)."""
    labels = [1.0 / (x + 1) for x in range(5)]
    labels += [0.0] * 5
    labels += [-0.5] * (nway - 10)
    return labels


def nway_dataset(teacher_examples: Iterable[Dict], nway: int = 50
                 ) -> List[Dict]:
    """Teacher-score examples {'qid','docids','scores'} (score-descending)
    -> listwise n-way examples {'qid','docids','labels'} (reference
    create_nway_dataset_from_score_dataset.py:12-30)."""
    out = []
    for ex in teacher_examples:
        docids = ex["docids"][:nway]
        if len(docids) < nway:
            continue  # reference asserts len >= nway; skip short lists
        scores = ex["scores"][:nway]
        assert all(scores[i] >= scores[i + 1] for i in range(len(scores) - 1)), \
            "teacher scores must be sorted desc"
        out.append({"qid": ex["qid"], "docids": docids,
                    "labels": nway_labels(nway)})
    return out


def truncate_examples(examples: Iterable[Dict], trunc_num: int) -> List[Dict]:
    """Truncate every aligned list field (smtids + all *scores) to the top
    `trunc_num` entries (reference truncate_lng_knp_json_example.py /
    truncate_the_early_score_score_jsonl_example.py)."""
    out = []
    for ex in examples:
        new = {}
        for key, val in ex.items():
            if isinstance(val, list):
                new[key] = val[:trunc_num]
            else:
                new[key] = val
        out.append(new)
    return out


def qrel_first_examples(qid_to_reldocid_to_score: Mapping[str, Mapping[str, float]],
                        docid_to_smtid_str: Mapping[str, str],
                        qid_smtid_rankdata: RankData,
                        max_new_token: int, decay: int = 2) -> List[Dict]:
    """Force qrel positives to rank 0: one example per (qid, rel docid) with
    the positive's smtid + UNDECAYED teacher score first, followed by the
    decay-weighted rankdata smtids sorted desc (reference
    add_qrel_first_create_json_example.py:36-92). Queries absent from the
    rankdata are skipped, as in the reference (:72-74)."""
    factor = DECAY_TO_FACTOR[decay][max_new_token]
    examples = []
    for qid, reldocid_to_score in qid_to_reldocid_to_score.items():
        qid = str(qid)
        if qid not in qid_smtid_rankdata:
            continue
        scored = {smtid: max(x[1] for x in pairs) * factor
                  for smtid, pairs in qid_smtid_rankdata[qid].items()}
        pairs = sorted(scored.items(), key=lambda x: x[1], reverse=True)
        smtids = [p[0] for p in pairs]
        scores = [p[1] for p in pairs]
        for reldocid, relscore in reldocid_to_score.items():
            relsmtid = docid_to_smtid_str[str(reldocid)]
            examples.append({"qid": qid,
                             "smtids": [relsmtid] + smtids,
                             "scores": [relscore] + scores})
    return examples


def merge_self_neg_sym_neg(qid_to_reldocid_to_rank: Mapping[str, Mapping[str, Sequence[Sequence]]],
                           qid_to_reldocid_to_score: Mapping[str, Mapping[str, float]],
                           qid_smtid_rankdata: RankData,
                           docid_to_smtid_str: Mapping[str, str],
                           max_new_token: int, decay: int = 2,
                           threshold: int = 80) -> List[Dict]:
    """Symmetric-hard-negative merge (reference
    merge_self_neg_sym_neg_for_jsonl_example.py:49-96): per (qid, rel docid)
    -> example led by the positive's smtid + UNDECAYED score, followed by
    the union of (a) the positive's symmetric hard negatives and (b) the
    query's self beam-search rankdata, both decay-weighted, max on
    collision, sorted desc, capped at `threshold` smtids total."""
    factor = DECAY_TO_FACTOR[decay][max_new_token]
    examples = []
    for qid, reldocid_to_rank in qid_to_reldocid_to_rank.items():
        qid = str(qid)
        self_scored = {}
        for smtid, pairs in qid_smtid_rankdata.get(qid, {}).items():
            self_scored[smtid] = max(x[1] for x in pairs) * factor
        for reldocid, rank in reldocid_to_rank.items():
            relsmtid = docid_to_smtid_str[str(reldocid)]
            merged: Dict[str, float] = {}
            for docid, score in rank:
                smtid = docid_to_smtid_str[str(docid)]
                s = factor * score
                merged[smtid] = max(merged.get(smtid, -np.inf), s)
            for smtid, s in self_scored.items():
                merged[smtid] = max(merged.get(smtid, -np.inf), s)
            relscore = qid_to_reldocid_to_score[qid][str(reldocid)]
            example = {"qid": qid, "smtids": [relsmtid], "scores": [relscore]}
            for smtid, s in sorted(merged.items(), key=lambda x: x[1],
                                   reverse=True):
                if smtid != relsmtid:
                    example["smtids"].append(smtid)
                    example["scores"].append(s)
                if len(example["smtids"]) == threshold:
                    break
            examples.append(example)
    return examples


def add_qrel_examples(qid_to_reldocid_to_score: Mapping[str, Mapping[str, float]],
                      docid_to_smtid_str: Mapping[str, str],
                      qid_smtid_rankdata: RankData,
                      max_new_token: int, decay: int = 2) -> List[Dict]:
    """Like qrel_first_examples but dedup-aware: the positive smtid is
    prepended ONLY when it is not already among the rankdata smtids; when
    present, the example keeps the rankdata order/scores unchanged
    (reference add_qrel_to_qid_smtid_rerank_and_create_jsonl_example.py:
    62-89, relrate accounting)."""
    factor = DECAY_TO_FACTOR[decay][max_new_token]
    examples = []
    for qid, reldocid_to_score in qid_to_reldocid_to_score.items():
        qid = str(qid)
        if qid not in qid_smtid_rankdata:
            continue
        scored = {smtid: max(x[1] for x in pairs) * factor
                  for smtid, pairs in qid_smtid_rankdata[qid].items()}
        pairs = sorted(scored.items(), key=lambda x: x[1], reverse=True)
        smtids = [p[0] for p in pairs]
        scores = [p[1] for p in pairs]
        for reldocid, relscore in reldocid_to_score.items():
            relsmtid = docid_to_smtid_str[str(reldocid)]
            if relsmtid in scored:
                examples.append({"qid": qid, "smtids": smtids,
                                 "scores": scores})
            else:
                examples.append({"qid": qid,
                                 "smtids": [relsmtid] + smtids,
                                 "scores": [relscore] + scores})
    return examples
