"""The full RIPOR 3-phase training recipe, end-to-end in one function, in
PyTorch.

Port of ripor_tpu/pipeline/full_recipe.py, which mirrors the reference's
chained shell pipelines (full_scripts/full_train_t5seq_encoder_{0,1}.sh +
full_train_t5seq_seq2seq_0_1_pipeline.sh + full_lng_knp_train_pipline.sh
:28-100 + marco_train_t5seq_cross_encoder.sh + all_aq_pipline; SURVEY.md
§3.5) as one resumable function:

  teacher  BM25 run -> BCE examples -> BertCrossEncoder (stands in for the
           off-the-shelf MiniLM teacher this image cannot download)
  phase 1  two MarginMSE distillation stages: stage 0 trains on the
           TEACHER-RESCORED BM25 run (full_train_t5seq_encoder_0.sh:13),
           stage 1 re-trains from the stage-0 checkpoint on SELF-MINED
           candidates — the stage-0 model's own dense retrieval,
           teacher-rescored (full_train_t5seq_encoder_1.sh:12-15)
  docids   corpus encode (stage-1 model) -> RQ -> docid_to_smtid +
           codebook install
  phase 2  seq2seq CE on query->smtid pairs (doc2query pseudo-queries,
           teacher-filtered, when no real query_to_docid file is given) +
           MarginMSE on the stage-1 model's retrieval, teacher-rescored
  phase 3  flywheel datagen seeded by the CURRENT model's dense retrieval
           (reference retrieve_train_queries, evaluate.py:229-266), teacher
           rescoring + decay merge, then the prefix curriculum: sub-smtid
           MarginMSE at 4, lng_knp at 8/16/32

Every stage writes the JAX package's artifact names into the workspace
and is skipped when its outputs exist, so an interrupted run resumes (a
checkpoint is params.pt, or the JAX package's Orbax ``params/``).
Training, encoding, calibration and the teacher run in float32; beam
searches (the flywheel's D^B and every evaluation) in bfloat16, as the
JAX package's searches do.
"""
from __future__ import annotations

import itertools
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ripor_tpu_torch.data.collators import (
    BertBceCollator,
    MarginMSECollator,
    PretrainCollator,
    Seq2SeqCollator,
    batches_from_bce,
    batches_from_joint,
    batches_from_seq2seq,
    batches_from_teacher_examples,
)
from ripor_tpu_torch.data.datasets import (
    BceExamples,
    Collection,
    Seq2SeqExamples,
    TeacherScoreExamples,
    build_bce_examples,
    load_docid_to_smtid,
    load_qrel,
    save_bce_examples,
)
from ripor_tpu_torch.data.tokenizer import tokenize_queries
from ripor_tpu_torch.decode.beam import resolve_device
from ripor_tpu_torch.evaluation.bm25 import BM25Index
from ripor_tpu_torch.evaluation.reranker import load_bert_teacher, rerank_pairs
from ripor_tpu_torch.evaluation.retriever import dense_topk
from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.convert import init_params
from ripor_tpu_torch.models.cross_encoder import BertCrossEncoder
from ripor_tpu_torch.models.ripor import RiporModel
from ripor_tpu_torch.pipeline.datagen import (attach_lng_knp_scores,
                                              merge_self_neg_sym_neg,
                                              prefix_smtid_strings,
                                              pseudo_query_examples,
                                              qrel_added_teacher_examples,
                                              teacher_run_to_examples)
from ripor_tpu_torch.pipeline.e2e import _small_cfg
from ripor_tpu_torch.pipeline.flywheel import (datagen_round, read_jsonl,
                                               search_model, write_jsonl)
from ripor_tpu_torch.pipeline.recipe import (
    Workspace,
    stage_build_docids,
    stage_build_trie,
    stage_encode_corpus,
    stage_evaluate,
    stage_install_codebooks,
    stage_retrieve,
    stage_tokenizer,
    stage_train,
)
from ripor_tpu_torch.train.calibrate import calibrate_trainset
from ripor_tpu_torch.train.checkpoint import has_params, save_params
from ripor_tpu_torch.train.trainer import TrainConfig
from ripor_tpu_torch.trie.build import DocIdTrie, build_trie


class _QueryOverlay:
    """``queries[qid]`` view that resolves pseudo-query ids from a dict and
    everything else from the base Collection (phase3_pseudo_rank)."""

    def __init__(self, base, extra: Dict[str, str]):
        self._base, self._extra = base, extra

    def __getitem__(self, qid: str) -> str:
        t = self._extra.get(str(qid))
        return t if t is not None else self._base[qid]


def _epochs_steps(n_examples: int, batch_size: int, epochs: int) -> int:
    return max(1, epochs * max(1, n_examples // batch_size))


def _stage_bm25_run(ws: Workspace, queries: Collection, docs: Collection,
                    topk: int) -> Dict[str, Dict[str, float]]:
    """First-stage lexical run (the reference's prebuilt Anserini artifact,
    data/msmarco-full/bm25_run — full_train_t5seq_encoder_0.sh:13)."""
    path = ws.path("bm25_run.json")
    if path.exists():
        return json.loads(path.read_text())
    ws.log(f"BM25 run over {len(docs)} docs / {len(queries)} queries")
    index = BM25Index(docs.texts)
    run = index.run(queries.ids, queries.texts, docs.ids, topk=topk)
    path.write_text(json.dumps(run))
    return run


def _train_bert_teacher(ws: Workspace, tok, queries: Collection,
                        docs: Collection, qrel,
                        run: Mapping[str, Mapping[str, float]],
                        epochs: int, batch_size: int, seed: int,
                        geometry: Optional[Dict] = None,
                        learning_rate: float = 1e-3,
                        neg_sample: int = 8,
                        warmup: float = 0.0,
                        stage: str = "bert_teacher",
                        device=None) -> str:
    """Train the BertCrossEncoder teacher (float32, on ``device``, default
    "cuda") on bce_examples built from the qrel + the run's candidates
    (reference build_bce_example_for_t5seq_encoder.py draws negatives from
    the query's run) and save it with its geometry. Returns the checkpoint
    dir. The initial params come from ``init_params`` on a generator
    seeded by ``seed`` (flax's distributions, other values). ``warmup``
    is the lr-warmup fraction of the total steps; ``stage`` names the
    checkpoint/trainset so the hard-negative refresh pass
    (``teacher_refresh``) can coexist with the stage-0 teacher."""
    device = resolve_device(device)
    ckpt = ws.path(f"checkpoints/{stage}")
    geo = geometry or dict(d_model=64, num_layers=2, num_heads=4, d_ff=128,
                           max_position=128)
    if has_params(ckpt):
        return str(ckpt)
    bce_path = ws.path("bce_examples.train.tsv" if stage == "bert_teacher"
                       else f"bce_examples.{stage}.tsv")
    if not bce_path.exists():
        save_bce_examples(bce_path, build_bce_examples(
            qrel, run, neg_sample=neg_sample, seed=seed))
    examples = BceExamples(bce_path)
    coll = BertBceCollator(tok, queries, docs, max_length=64)
    model = BertCrossEncoder(vocab_size=tok.vocab_size, device=device, **geo)
    params = init_params(model,
                         torch.Generator(device=device).manual_seed(seed),
                         device=device)
    bz = min(batch_size, len(examples))
    total = _epochs_steps(len(examples), bz, epochs)
    tcfg = TrainConfig(loss_type="bert_bce", learning_rate=learning_rate,
                       total_steps=total,
                       warmup_steps=int(warmup * total))
    batches = batches_from_bce(examples, coll, bz, epochs=epochs,
                               drop_last=False)
    stage_train(ws, stage, model, params, tcfg, batches, None,
                rng_seed=seed)
    (ckpt / "bert_geometry.json").write_text(json.dumps(geo))
    return str(ckpt)


def _teacher_quality(ws: Workspace, teacher_fn, tok, queries: Collection,
                     docs: Collection, bce_path,
                     batch_size: int = 64,
                     stage: str = "bert_teacher") -> Dict[str, float]:
    """Measure the trained teacher's pos/neg logit separation on its own
    trainset — the margin SCALE the student will distill (a teacher left
    at init gives ~0 margins and teaches every MarginMSE phase to make all
    scores equal). Cached in the workspace next to the checkpoint."""
    qpath = ws.path(f"checkpoints/{stage}/teacher_quality.json")
    if qpath.exists():
        return json.loads(qpath.read_text())
    rows = BceExamples(bce_path).rows
    scored = rerank_pairs(teacher_fn, tok, queries, docs,
                          [(q, d) for q, d, _ in rows],
                          batch_size=batch_size, max_length=64)
    pos = [scored[q][d] for q, d, lab in rows if lab == 1]
    neg = [scored[q][d] for q, d, lab in rows if lab != 1]
    q = {"pos_logit_mean": float(np.mean(pos)),
         "neg_logit_mean": float(np.mean(neg)),
         "margin": float(np.mean(pos) - np.mean(neg)),
         "n_pos": len(pos), "n_neg": len(neg)}
    qpath.write_text(json.dumps(q))
    return q


def _teacher_trainset(ws: Workspace, name: str,
                      run: Mapping[str, Mapping[str, float]],
                      teacher_pair_scores,
                      qid_to_reldocid_to_score: Mapping[str, Mapping[str, float]],
                      top_k: int) -> str:
    """Candidate run -> teacher-rescored, qrel-anchored MarginMSE trainset
    (the reference chain rerank_for_create_trainset{,_2} (rerank.py:41-105)
    + add_qrel_to_rerank_run.py). Returns the JSONL path."""
    path = ws.path(name)
    if path.exists():
        return str(path)
    ws.log(f"teacher-rescoring run -> {name}")
    pairs = sorted({(str(q), str(d)) for q, docs in run.items() for d in docs})
    scored = teacher_pair_scores(pairs)
    rows = qrel_added_teacher_examples(
        teacher_run_to_examples(scored, top_k=top_k),
        qid_to_reldocid_to_score)
    # a row needs >= 2 candidates to sample a negative (dataset.py:589-595)
    rows = [r for r in rows if len(r["docids"]) >= 2]
    write_jsonl(str(path), rows)
    return str(path)


def _trainset_mrr(path: str, qrel: Mapping[str, Mapping[str, int]],
                  k: int = 10) -> float:
    """MRR@k of the qrel positive within each teacher-rescored trainset
    row, ranking by the teacher's scores — the TEACHER's own candidate-
    ranking quality, i.e. the quality of the distillation target itself,
    which every MarginMSE phase pulls the student toward."""
    rr = []
    for ex in read_jsonl(path):
        rel = {d for d, r in qrel.get(str(ex["qid"]), {}).items() if r > 0}
        if not rel:
            continue
        order = np.argsort(-np.asarray(ex["scores"]))
        ranked = [ex["docids"][i] for i in order[:k]]
        r = next((i + 1 for i, d in enumerate(ranked) if d in rel), None)
        rr.append(1.0 / r if r else 0.0)
    return float(np.mean(rr)) if rr else 0.0


def _dense_run(ws: Workspace, name: str, embs: np.ndarray,
               model: RiporModel, params, tok, queries: Collection,
               docids: Sequence[str], topk: int,
               batch_size: int) -> Dict[str, Dict[str, float]]:
    """Dense retrieval of the train queries over a doc-embedding matrix
    (reference retrieve_train_queries, evaluate.py:229-266), with
    ``model`` (a RiporModel, in its dtype on its device) holding
    ``params`` (a state_dict loaded into it, or None). Cached."""
    path = ws.path(name)
    if path.exists():
        return json.loads(path.read_text())
    if params is not None:
        model.load_state_dict(params)
    dev = next(model.parameters()).device
    reps = []
    n = len(queries)
    with torch.inference_mode():
        for s in range(0, n, batch_size):
            texts = [queries.text_at(i)
                     for i in range(s, min(s + batch_size, n))]
            pad = batch_size - len(texts)
            ids, mask = tokenize_queries(tok, texts + [""] * pad, 64)
            r = model.dense_rep(torch.as_tensor(ids, device=dev),
                                torch.as_tensor(mask, device=dev))
            reps.append(r.float().cpu().numpy()[:len(texts)])
    q = np.concatenate(reps, axis=0)
    scores, idx = dense_topk(q, np.asarray(embs, np.float32),
                             min(topk, len(docids)), device=dev)
    run = {str(qid): {str(docids[d]): float(s)
                      for d, s in zip(qi, qs)}
           for qid, qi, qs in zip(queries.ids, idx, scores)}
    path.write_text(json.dumps(run))
    return run


def _pseudo_query_trainset(ws: Workspace, docs: Collection, queries,
                           qrel, teacher_pair_scores, per_doc: int,
                           seed: int) -> str:
    """query->docid seq2seq source when no real doc2query artifact exists:
    sample word spans from each doc as pseudo-queries, teacher-score every
    (pseudo-query, doc) pair, and keep pairs above the median score via
    datagen.pseudo_query_examples — the same filter shape as the
    reference's create_pseudo_query_to_docid_map.py:18-27 (its threshold
    is an absolute MiniLM logit; this one a quantile, since the trained
    toy teacher has its own scale). Real train-query->positive pairs ride
    along, as in the reference's query_to_docid.train.json."""
    path = ws.path("query_to_docid.train.jsonl")
    if path.exists():
        return str(path)
    ws.log("building pseudo-query seq2seq trainset")
    rng = np.random.default_rng(seed)
    pq_texts: Dict[str, str] = {}
    pairs: List[Tuple[str, str]] = []
    for did, text in zip(docs.ids, docs.texts):
        words = text.split()
        for j in range(per_doc):
            if len(words) <= 2:
                span = words
            else:
                ln = int(rng.integers(2, min(7, len(words) + 1)))
                s = int(rng.integers(0, len(words) - ln + 1))
                span = words[s:s + ln]
            pqid = f"pq_{did}_{j}"
            pq_texts[pqid] = " ".join(span)
            pairs.append((pqid, str(did)))
    scored = teacher_pair_scores(pairs, query_texts=pq_texts)
    d2r = {}
    for pqid, did in pairs:
        d2r.setdefault(did, {})[pqid] = scored[pqid][did]
    all_scores = [s for rd in d2r.values() for s in rd.values()]
    thresh = float(np.median(all_scores))
    _, filtered = pseudo_query_examples(d2r, pq_texts,
                                        score_threshold=thresh)
    rows = list(filtered)
    for qid, rels in qrel.items():
        for d, r in rels.items():
            if r > 0:
                rows.append({"docid": str(d), "query": queries[qid]})
    write_jsonl(str(path), rows)
    return str(path)


def run_full_recipe(workspace: str, docs_dir: str, queries_dir: str,
                    qrel_path: str,
                    M: int = 8, K: int = 32, vocab_size: int = 600,
                    cfg: Optional[RiporConfig] = None,
                    phase1_epochs: int = 10, teacher_epochs: int = 20,
                    s2s_epochs: int = 40, mm_epochs: int = 10,
                    phase3_epochs: int = 10,
                    curriculum: Optional[Sequence[int]] = None,
                    num_beams: int = 10, topk: int = 100,
                    batch_size: int = 16, decay: int = 2,
                    teacher_geometry: Optional[Dict] = None,
                    seed: int = 0,
                    tokenizer_kind: str = "unigram",
                    bm25_topk: int = 50, retrieve_topk: int = 50,
                    trainset_topk: int = 200,
                    query_to_docid_path: Optional[str] = None,
                    pseudo_queries_per_doc: int = 2,
                    dr_topk: int = 100,
                    phase3_sym_neg: bool = False,
                    prefix_eval: Sequence[int] = (),
                    datagen_num_beams: Optional[int] = None,
                    teacher_lr: float = 1e-3,
                    min_teacher_margin: float = 0.0,
                    mm_lr: float = 1e-4, phase3_lr: float = 1e-4,
                    phase3_prefix_heads: bool = True,
                    calibrate_teacher_scale: bool = False,
                    teacher_neg_sample: int = 8,
                    min_teacher_mrr: float = 0.0,
                    teacher_warmup: float = 0.0,
                    teacher_refresh: bool = False,
                    phase3_seq2seq_rehearsal: bool = False,
                    phase3_rehearsal_lr: float = 1e-3,
                    phase3_rehearsal_epochs: int = 1,
                    phase3_joint_seq2seq: bool = False,
                    phase3_joint_weight: float = 1.0,
                    phase3_rehearsal_max_steps: int = 0,
                    phase3_pseudo_rank: int = 0,
                    phase3_l2sp: float = 0.0,
                    device=None) -> Dict[str, Dict[str, float]]:
    """Run phases 1..3 on a corpus slice on ``device`` (default "cuda");
    returns per-phase retrieval metrics {"phase2": {...}, "phase3": {...}}
    (the reference's end state after full_lng_knp_train_pipline.sh).

    The keywords are the JAX function's, with its defaults and meaning;
    its docstring records the measurements behind each. In short:
    ``tokenizer_kind="word"`` makes the run deterministic;
    ``prefix_eval=(4, 8)`` adds prefix-truncated retrieval metrics
    ("phaseN_prefixP"); ``phase3_sym_neg`` builds phase-3 examples with
    datagen.merge_self_neg_sym_neg; ``query_to_docid_path`` supplies a
    real doc2query JSONL and skips pseudo-query generation;
    ``min_teacher_margin`` and ``min_teacher_mrr`` gate on the trained
    teacher's pos-neg logit margin and its candidate-ranking MRR@10
    (ValueError below them); ``calibrate_teacher_scale`` rescales the
    teacher's scores to the student's margin scale (train/calibrate.py)
    before phase-2 MarginMSE and each phase-3 stage; ``teacher_refresh``
    retrains the teacher on BM25 ∪ the stage-0 model's self-mined run and
    moves the MRR gate to it; ``phase3_seq2seq_rehearsal`` (sized by
    ``phase3_rehearsal_lr``/``_epochs``/``_max_steps``) adds a seq2seq
    pass after each rank stage; ``phase3_joint_seq2seq`` (weighted by
    ``phase3_joint_weight``) trains the rank stages with the joint
    lng_knp + seq2seq loss instead; ``phase3_pseudo_rank`` adds up to
    that many pseudo-queries per doc as rank-training queries;
    ``phase3_l2sp`` pulls the rank stages toward the phase-2 params.

    The initial RIPOR and teacher params come from ``init_params`` on a
    generator seeded by ``seed``: flax's distributions with other values
    than flax draws from the same seed."""
    device = resolve_device(device)
    ws = Workspace(workspace)
    docs = Collection(docs_dir)
    queries = Collection(queries_dir)
    qrel = load_qrel(qrel_path)

    tok = stage_tokenizer(ws, docs.texts + queries.texts, vocab_size,
                          kind=tokenizer_kind)
    cfg = cfg or _small_cfg(M, K, tok.vocab_size)
    # curriculum from the RESOLVED config's M — a custom cfg with M=32 must
    # get the full 4->8->16->32 ladder even if the M parameter was left at
    # its default (reference full_lng_knp_train_pipline.sh:28-100)
    curriculum = list(curriculum) if curriculum is not None else sorted(
        {p for p in (4, 8, 16, 32) if p < cfg.M} | {cfg.M})
    model = RiporModel(cfg, device=device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)

    # ---- BM25 + cross-encoder teacher -----------------------------------
    bm25 = _stage_bm25_run(ws, queries, docs, topk=bm25_topk)
    teacher_ckpt = _train_bert_teacher(ws, tok, queries, docs, qrel, bm25,
                                       epochs=teacher_epochs,
                                       batch_size=batch_size, seed=seed,
                                       geometry=teacher_geometry,
                                       learning_rate=teacher_lr,
                                       neg_sample=teacher_neg_sample,
                                       warmup=teacher_warmup, device=device)
    teacher_fn = load_bert_teacher(teacher_ckpt, tok.vocab_size,
                                   device=device)
    tq = _teacher_quality(ws, teacher_fn, tok, queries, docs,
                          ws.path("bce_examples.train.tsv"))
    ws.log(f"teacher quality: margin={tq['margin']:.3f} "
           f"(pos {tq['pos_logit_mean']:.3f} / neg {tq['neg_logit_mean']:.3f})")
    if tq["margin"] < min_teacher_margin:
        raise ValueError(
            f"teacher pos-neg logit margin {tq['margin']:.3f} < required "
            f"{min_teacher_margin} — distilling from a non-separating "
            f"teacher collapses the student's margins; raise teacher_epochs"
            f"/geometry or lower teacher_lr")

    def teacher_pair_scores(pairs, query_texts=None):
        return rerank_pairs(teacher_fn, tok,
                            query_texts if query_texts is not None
                            else queries,
                            docs, list(pairs), batch_size=64, max_length=64)

    # teacher scores of the qrel (q, rel doc) pairs — the reference's
    # qid_to_reldocid_to_score.json (add_qrel_to_rerank_run.py:6)
    rel_path = ws.path("qid_to_reldocid_to_score.json")
    if not rel_path.exists():
        rel_pairs = [(str(q), str(d)) for q, rels in qrel.items()
                     for d, r in rels.items() if r > 0]
        scored = teacher_pair_scores(rel_pairs)
        rel_path.write_text(json.dumps(scored))
    qid_to_reldocid_to_score = json.loads(rel_path.read_text())

    # ---- phase 1: two-stage dense distillation ---------------------------
    # stage 0: teacher-rescored BM25 candidates
    # (full_train_t5seq_encoder_0.sh: loss t5seq_pretrain_margin_mse)
    pre_coll = PretrainCollator(tok, queries, docs, max_length=64)

    def _pretrain_stage(stage_name: str, trainset_path: str, p):
        pre_examples = TeacherScoreExamples(trainset_path)
        bz = min(batch_size, len(pre_examples))
        tcfg = TrainConfig(loss_type="t5seq_pretrain_margin_mse",
                           learning_rate=1e-3,
                           total_steps=_epochs_steps(len(pre_examples), bz,
                                                     phase1_epochs))
        return stage_train(
            ws, stage_name, model, p, tcfg,
            batches_from_teacher_examples(pre_examples, pre_coll, bz,
                                          epochs=phase1_epochs,
                                          drop_last=False),
            cfg, rng_seed=seed)

    def holding(p) -> RiporModel:
        """The float32 model, holding ``p`` (stage_train may restore a
        checkpoint without loading it into the model)."""
        model.load_state_dict(p)
        return model

    t0 = _teacher_trainset(ws, "pretrain_trainset_0.jsonl", bm25,
                           teacher_pair_scores, qid_to_reldocid_to_score,
                           top_k=trainset_topk)
    tmrr = _trainset_mrr(t0, qrel)
    ws.log(f"teacher candidate-ranking MRR@10 (rescored BM25): {tmrr:.4f}")
    # with a refresh pass coming, the stage-0 teacher only needs to seed
    # phase-1 stage 0 — the quality gate moves to the refreshed teacher
    if not teacher_refresh and tmrr < min_teacher_mrr:
        raise ValueError(
            f"teacher candidate-ranking MRR@10 {tmrr:.4f} < required "
            f"{min_teacher_mrr} — the distillation target ranks worse than "
            f"the gate; every MarginMSE phase would pull the student toward "
            f"a weaker ranking. Raise teacher geometry/epochs/neg_sample")
    params = _pretrain_stage("phase1_pretrain", t0, params)

    # stage 1: SELF-MINED candidates — dense retrieval by the stage-0
    # model, teacher-rescored (full_train_t5seq_encoder_1.sh:12-15)
    embs0 = stage_encode_corpus(ws, holding(params), docs, tok,
                                max_length=64, batch_size=batch_size,
                                out_name="doc_embeds_phase1_0.npy")
    run0 = _dense_run(ws, "dense_run_phase1_0.json", embs0, model, params,
                      tok, queries, docs.ids, topk=retrieve_topk,
                      batch_size=batch_size)

    if teacher_refresh:
        # hard-negative teacher refresh: retrain from scratch on
        # BM25 ∪ self-mined negatives, then swap it in for everything
        # downstream (see the run_full_recipe docstring)
        union = {q: dict(ds) for q, ds in bm25.items()}
        for q, ds in run0.items():
            union.setdefault(q, {}).update(ds)
        teacher_ckpt = _train_bert_teacher(
            ws, tok, queries, docs, qrel, union, epochs=teacher_epochs,
            batch_size=batch_size, seed=seed, geometry=teacher_geometry,
            learning_rate=teacher_lr, neg_sample=teacher_neg_sample,
            warmup=teacher_warmup, stage="bert_teacher_refresh",
            device=device)
        teacher_fn = load_bert_teacher(teacher_ckpt, tok.vocab_size,
                                       device=device)
        tq = _teacher_quality(ws, teacher_fn, tok, queries, docs,
                              ws.path("bce_examples.bert_teacher_refresh.tsv"),
                              stage="bert_teacher_refresh")
        ws.log(f"refreshed teacher quality: margin={tq['margin']:.3f} "
               f"(pos {tq['pos_logit_mean']:.3f} / "
               f"neg {tq['neg_logit_mean']:.3f})")
        if tq["margin"] < min_teacher_margin:
            raise ValueError(
                f"refreshed teacher margin {tq['margin']:.3f} < required "
                f"{min_teacher_margin}")
        # the rel-pair scores must come from the SAME teacher that scores
        # the negatives — MarginMSE margins are rel minus neg
        rel_path = ws.path("qid_to_reldocid_to_score.refresh.json")
        if not rel_path.exists():
            rel_pairs = [(str(q), str(d)) for q, rels in qrel.items()
                         for d, r in rels.items() if r > 0]
            rel_path.write_text(json.dumps(teacher_pair_scores(rel_pairs)))
        qid_to_reldocid_to_score = json.loads(rel_path.read_text())

    t1 = _teacher_trainset(ws, "pretrain_trainset_1.jsonl", run0,
                           teacher_pair_scores, qid_to_reldocid_to_score,
                           top_k=trainset_topk)
    if teacher_refresh:
        tmrr1 = _trainset_mrr(t1, qrel)
        ws.log("refreshed teacher candidate-ranking MRR@10 (self-mined "
               f"run): {tmrr1:.4f}")
        if tmrr1 < min_teacher_mrr:
            raise ValueError(
                f"refreshed teacher candidate-ranking MRR@10 {tmrr1:.4f} < "
                f"required {min_teacher_mrr} — the distillation target "
                f"ranks worse than the gate; raise teacher geometry/"
                f"epochs or widen the negative pool")
    params = _pretrain_stage("phase1_pretrain_1", t1, params)
    # snapshot: the phase-2 MM candidate run below must score queries with
    # THIS model (the one that encoded the corpus), not the post-codebook
    # post-seq2seq params — the reference reuses the stage-1 run verbatim
    params_stage1 = params

    # ---- DocID build ------------------------------------------------------
    embs = stage_encode_corpus(ws, holding(params), docs, tok, max_length=64,
                               batch_size=batch_size)
    codes = stage_build_docids(ws, embs, docs.ids, M=cfg.M, K=cfg.K,
                               device=device)
    params = stage_install_codebooks(ws, params)
    docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
    d2c = dict(zip(docids, codes))

    # ---- phase 2: seq2seq (pseudo-queries) + teacher MarginMSE ------------
    s2s_path = (query_to_docid_path
                or _pseudo_query_trainset(ws, docs, queries, qrel,
                                          teacher_pair_scores,
                                          per_doc=pseudo_queries_per_doc,
                                          seed=seed))
    s2s = Seq2SeqExamples(s2s_path)
    bz = min(batch_size, len(s2s))
    tcfg = TrainConfig(loss_type="t5seq_aq_encoder_seq2seq",
                       learning_rate=1e-3,
                       total_steps=_epochs_steps(len(s2s), bz, s2s_epochs))
    params = stage_train(
        ws, "phase2_seq2seq", model, params, tcfg,
        batches_from_seq2seq(s2s, Seq2SeqCollator(tok, d2c, max_length=32),
                             bz, epochs=s2s_epochs, drop_last=False),
        cfg, rng_seed=seed)

    # MarginMSE on the stage-1 model's retrieval, teacher-rescored (the
    # reference reuses t5_docid_gen_encoder_1's qrel_added run for
    # seq2seq_1, full_train_t5seq_seq2seq_0_1_pipeline.sh:55)
    run1 = _dense_run(ws, "dense_run_phase1_1.json", embs, model,
                      params_stage1, tok, queries, docids,
                      topk=retrieve_topk, batch_size=batch_size)
    mm_path = _teacher_trainset(ws, "phase2_mm_trainset.jsonl", run1,
                                teacher_pair_scores,
                                qid_to_reldocid_to_score,
                                top_k=trainset_topk)
    if calibrate_teacher_scale:
        cal = ws.path("phase2_mm_trainset.cal.jsonl")
        if not cal.exists():
            stats = calibrate_trainset(
                str(mm_path), str(cal), model, params, tok, queries,
                docid_to_codes=d2c, smtid_as_docid=False,
                alphas_out=str(ws.path("calibration_phase2_mm.json")),
                seed=seed)
            ws.log(f"phase2 MM scale calibration: alpha={stats['alpha']:.3f}"
                   f" (student margin {stats['student_margin_mean']:.1f}"
                   f"±{stats['student_margin_std']:.1f}, teacher "
                   f"{stats['teacher_margin_mean']:.1f}"
                   f"±{stats['teacher_margin_std']:.1f})")
        mm_path = str(cal)
    mm = TeacherScoreExamples(mm_path)
    bz = min(batch_size, len(mm))
    # lr 1e-4 per the reference (full_train_t5seq_seq2seq_0_1_pipeline.sh:58)
    tcfg = TrainConfig(loss_type="t5seq_aq_encoder_margin_mse",
                       learning_rate=mm_lr,
                       total_steps=_epochs_steps(len(mm), bz, mm_epochs))
    params = stage_train(
        ws, "phase2_margin_mse", model, params, tcfg,
        batches_from_teacher_examples(
            mm, MarginMSECollator(tok, queries, d2c, max_length=64), bz,
            epochs=mm_epochs, drop_last=False),
        cfg, rng_seed=seed)

    trie = stage_build_trie(ws, codes, cfg.K)

    def _eval_phase(tag: str, p) -> Dict[str, Dict[str, float]]:
        retriever = search_model(cfg, p, torch.bfloat16, device)
        out = {tag: stage_evaluate(
            ws, stage_retrieve(ws, cfg, retriever, tok, queries, trie,
                               docids, num_beams=num_beams, topk=topk,
                               run_name=f"run_{tag}.json"),
            qrel, perf_name=f"perf_{tag}.json")}
        for plen in prefix_eval:
            ptrie = stage_build_prefix_trie(ws, codes, cfg.K, plen)
            prun = stage_retrieve(ws, cfg, retriever, tok, queries, ptrie,
                                  docids, num_beams=num_beams, topk=topk,
                                  run_name=f"run_{tag}_prefix{plen}.json",
                                  max_steps=plen)
            out[f"{tag}_prefix{plen}"] = stage_evaluate(
                ws, prun, qrel, perf_name=f"perf_{tag}_prefix{plen}.json")
        return out

    metrics = _eval_phase("phase2", params)

    # ---- phase 3: flywheel + prefix curriculum ----------------------------
    # D^R seeds: the CURRENT model's dense retrieval top-dr_topk + qrel
    # positives (reference retrieve_train_queries -> teacher rerank ->
    # add_qrel -> group by prefix; SURVEY.md §3.5)
    embs2 = stage_encode_corpus(ws, holding(params), docs, tok,
                                max_length=64, batch_size=batch_size,
                                out_name="doc_embeds_phase2.npy")
    run2 = _dense_run(ws, "dense_run_phase2.json", embs2, model, params,
                      tok, queries, docids, topk=min(dr_topk, len(docids)),
                      batch_size=batch_size)
    qid_to_docids: Dict[str, List[str]] = {}
    for qid in queries.ids:
        pos = [str(d) for d, r in qrel.get(str(qid), {}).items() if r > 0]
        cand = [d for d in run2.get(str(qid), {}) if d not in set(pos)]
        if pos or cand:
            qid_to_docids[str(qid)] = pos + cand

    # pseudo-queries as rank-training positives (see docstring): every doc
    # gets an upward rank gradient from its own (teacher-filtered) pseudo-
    # queries; beam mining inside datagen_round supplies their negatives
    q3, score3 = queries, teacher_pair_scores
    if phase3_pseudo_rank > 0:
        pq_texts: Dict[str, str] = {}
        per_doc_n: Dict[str, int] = {}
        train_texts = set(queries.texts)
        for i, r in enumerate(read_jsonl(str(s2s_path))):
            d = str(r["docid"])
            if r["query"] in train_texts:
                continue  # train-query rows ride along in the s2s set
                          # (_pseudo_query_trainset) and are already in
                          # qid_to_docids under their real qid
            if per_doc_n.get(d, 0) >= phase3_pseudo_rank:
                continue
            per_doc_n[d] = per_doc_n.get(d, 0) + 1
            pqid = f"pq{i}"
            pq_texts[pqid] = r["query"]
            qid_to_docids[pqid] = [d]
        q3 = _QueryOverlay(queries, pq_texts)
        score3 = lambda pairs: teacher_pair_scores(pairs, query_texts=q3)
        ws.log(f"phase3 pseudo-rank: +{len(pq_texts)} pseudo-queries "
               f"covering {len(per_doc_n)}/{len(docids)} docs")

    # L2-SP anchor = the phase-2 entry state, for the rank (mnt) stages
    # only — a rehearsal stage, when enabled, IS the restoring mechanism
    # and must stay free to move
    anchor3 = params if phase3_l2sp > 0 else None

    for plen in curriculum:
        ds_path = ws.path(f"lng_knp_qid_smtids_scores_{plen}.train.json")
        if not ds_path.exists():
            ws.log(f"phase3 datagen at prefix {plen}")
            merged, rankdata, pair_scores = datagen_round(
                cfg, params, tok, q3, qid_to_docids, codes, docids,
                score3, prefix_len=plen,
                num_beams=datagen_num_beams or min(num_beams, 10),
                batch_size=4, decay=decay, return_intermediates=True,
                device=device)
            if phase3_sym_neg:
                p_str = prefix_smtid_strings(codes, docids, plen)
                # symmetric hard negatives per (qid, rel docid): the
                # query's teacher-scored candidates (the reference's
                # symmetric_hard_neg artifact holds the POSITIVE's dense
                # neighbours; at slice scale the query's own candidates are
                # that neighbourhood — both are rescored by the teacher)
                q2rank = {}
                for qid, rels in qid_to_reldocid_to_score.items():
                    if qid not in rankdata:
                        continue
                    cands = [[d, s] for d, s in
                             pair_scores.get(qid, {}).items()]
                    q2rank[qid] = {d: cands for d in rels}
                merged = merge_self_neg_sym_neg(
                    q2rank, qid_to_reldocid_to_score, rankdata, p_str,
                    max_new_token=plen, decay=decay)
                if plen > 4:
                    merged = attach_lng_knp_scores(merged, plen)
            write_jsonl(str(ds_path), merged)
        train_path = ds_path
        if calibrate_teacher_scale:
            cal = ws.path(
                f"lng_knp_qid_smtids_scores_{plen}.train.cal.json")
            if not cal.exists():
                plens = (tuple(p for p in (4, 8, 16) if p < plen)
                         if (phase3_prefix_heads and plen >= 8) else ())
                stats = calibrate_trainset(
                    str(ds_path), str(cal), model, params, tok, q3,
                    smtid_as_docid=True, prefix_lengths=plens,
                    alphas_out=str(ws.path(f"calibration_phase3_{plen}.json")),
                    seed=seed + plen)
                alphas = {k: round(v, 3) for k, v in stats.items()
                          if k.startswith("alpha")}
                ws.log(f"phase3 prefix-{plen} scale calibration: {alphas}")
            train_path = cal
        examples = TeacherScoreExamples(train_path, smtid_as_docid=True)
        if plen >= 8 and phase3_prefix_heads:
            loss_type = "t5seq_aq_encoder_lng_knp_margin_mse"
            prefix = examples.prefix_lengths_present()
        else:
            # sub-smtid stage, or phase3_prefix_heads=False — the paper's
            # "w/o prefix-oriented" flat ablation trains the FULL-length
            # margin only (no rank_4/8/16 heads)
            loss_type = "t5seq_aq_encoder_margin_mse"
            prefix = ()
        coll = MarginMSECollator(tok, q3, None, max_length=64,
                                 smtid_as_docid=True, prefix_lengths=prefix)
        bz = min(batch_size, len(examples))
        if phase3_joint_seq2seq:
            # the declared joint config (reference arguments.py:97):
            # lng_knp rank margins + a seq2seq sub-batch per step. With no
            # prefix keys present (plen=4 sub-smtid stage, or the flat
            # ablation) the lng_knp term reduces exactly to the full
            # margin, so one joint loss covers every stage.
            loss_type = "t5seq_aq_encoder_lng_knp_margin_mse_and_seq2seq"
        # lr 1e-4 per the reference (full_lng_knp_train_pipline.sh:31,85)
        tcfg = TrainConfig(loss_type=loss_type, learning_rate=phase3_lr,
                           total_steps=_epochs_steps(len(examples), bz,
                                                     phase3_epochs),
                           l2sp_rate=phase3_l2sp,
                           loss_weights=(
                               {"seq2seq": phase3_joint_weight}
                               if (phase3_joint_seq2seq
                                   and phase3_joint_weight != 1.0)
                               else None))
        rank_batches = batches_from_teacher_examples(examples, coll, bz,
                                                     epochs=phase3_epochs,
                                                     drop_last=False)
        if phase3_joint_seq2seq:
            rank_batches = batches_from_joint(
                rank_batches, s2s, Seq2SeqCollator(tok, d2c, max_length=32),
                min(batch_size, len(s2s)), seed=seed + 500 + plen)
        params = stage_train(
            ws, f"phase3_mnt_{plen}", model, params, tcfg,
            rank_batches, cfg, rng_seed=seed + plen,
            anchor_params=anchor3)
        if phase3_seq2seq_rehearsal:
            # one seq2seq pass over the phase-2 trainset (pseudo-queries
            # for ALL docs + train queries) after each rank stage: the
            # alternating form of the reference's DECLARED rank+seq2seq
            # config t5seq_aq_encoder_lng_knp_margin_mse_and_seq2seq
            # (arguments.py:97)
            bz_r = min(batch_size, len(s2s))
            rhs_steps = _epochs_steps(len(s2s), bz_r,
                                      phase3_rehearsal_epochs)
            if phase3_rehearsal_max_steps > 0:
                rhs_steps = min(rhs_steps, phase3_rehearsal_max_steps)
            rcfg = TrainConfig(
                loss_type="t5seq_aq_encoder_seq2seq",
                learning_rate=phase3_rehearsal_lr,
                total_steps=rhs_steps)
            rhs_batches = batches_from_seq2seq(
                s2s, Seq2SeqCollator(tok, d2c, max_length=32), bz_r,
                epochs=phase3_rehearsal_epochs, drop_last=False)
            if phase3_rehearsal_max_steps > 0:
                rhs_batches = itertools.islice(rhs_batches, rhs_steps)
            params = stage_train(
                ws, f"phase3_s2s_rhs_{plen}", model, params, rcfg,
                rhs_batches, cfg, rng_seed=seed + 1000 + plen)

    # final checkpoint under the conventional name for the retrieve CLI
    final = ws.path("checkpoints/final")
    if not has_params(final):
        save_params(final, params, cfg)

    metrics.update(_eval_phase("phase3", params))
    ws.log(f"full recipe metrics: {metrics}")
    return metrics


def stage_build_prefix_trie(ws: Workspace, codes: np.ndarray, K: int,
                            prefix_len: int) -> DocIdTrie:
    """Trie over prefix-truncated codes for sub-smtid retrieval (reference
    builds these per max_new_token, full_evaluate...sh:176-205)."""
    name = f"trie_prefix{prefix_len}.npz"
    if ws.has(name):
        return DocIdTrie.load(ws.path(name))
    trie = build_trie(np.ascontiguousarray(codes[:, :prefix_len]), K)
    trie.save(ws.path(name))
    return trie
