"""End-to-end pipelines, in PyTorch.

Port of ripor_tpu/pipeline/e2e.py. ``run_e2e`` is the minimum end-to-end
slice (SURVEY.md §7.2, BASELINE config #1): tokenizer -> corpus encode ->
RQ DocIDs -> seq2seq training -> trie -> constrained-beam retrieval ->
trec metrics. ``run_train_from_config`` is the generic single-phase
trainer behind the ``train`` CLI (reference: t5_pretrainer/main.py), for
every loss family: RiporModel's, the cross-encoder teachers' and the
dense baselines'.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import torch

from ripor_tpu_torch.data.collators import (
    BertBceCollator,
    MarginMSECollator,
    PretrainCollator,
    Seq2SeqCollator,
    T5SeqBceCollator,
    batches_from_bce,
    batches_from_seq2seq,
    batches_from_teacher_examples,
)
from ripor_tpu_torch.data.datasets import (BceExamples, Collection,
                                           Seq2SeqExamples,
                                           TeacherScoreExamples,
                                           load_docid_to_smtid, load_qrel)
from ripor_tpu_torch.decode.beam import resolve_device
from ripor_tpu_torch.models.config import RiporConfig, T5Config
from ripor_tpu_torch.models.convert import init_params
from ripor_tpu_torch.models.cross_encoder import (BertCrossEncoder,
                                                  T5SeqCrossEncoder)
from ripor_tpu_torch.models.dense_encoder import T5DenseEncoder
from ripor_tpu_torch.models.ripor import RiporModel
from ripor_tpu_torch.pipeline.recipe import (
    Workspace,
    load_tokenizer,
    stage_build_docids,
    stage_build_trie,
    stage_encode_corpus,
    stage_evaluate,
    stage_install_codebooks,
    stage_retrieve,
    stage_tokenizer,
    stage_train,
)
from ripor_tpu_torch.train.checkpoint import load_params
from ripor_tpu_torch.train.trainer import TrainConfig


def _small_cfg(M: int, K: int, vocab_size: int) -> RiporConfig:
    return RiporConfig(
        t5=T5Config(vocab_size=vocab_size, d_model=256, d_kv=32, d_ff=1024,
                    num_layers=4, num_decoder_layers=4, num_heads=8,
                    dropout_rate=0.1),
        M=M, K=K)


def run_e2e(workspace: str, docs_dir: str, queries_dir: str, qrel_path: str,
            s2s_examples_path: Optional[str] = None,
            M: int = 8, K: int = 64, vocab_size: int = 4000,
            s2s_epochs: int = 40, learning_rate: float = 1e-3,
            batch_size: int = 32, num_beams: int = 10, topk: int = 100,
            seed: int = 0, d_model_cfg: Optional[RiporConfig] = None,
            device=None) -> Dict[str, float]:
    """The minimum end-to-end slice on ``device`` (default "cuda"): the
    JAX function's stages in its order, with the initial params from
    ``init_params`` on a generator seeded by ``seed`` (other values than
    flax's from the same seed). Encodes and trains in float32; retrieves
    with the params rounded to bf16, as the JAX search computes in bf16.
    Returns the metrics of stage_evaluate."""
    device = resolve_device(device)
    ws = Workspace(workspace)
    docs = Collection(docs_dir)
    queries = Collection(queries_dir)
    qrel = load_qrel(qrel_path)

    tok = stage_tokenizer(ws, docs.texts + queries.texts, vocab_size)
    cfg = d_model_cfg or _small_cfg(M, K, tok.vocab_size)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    model = RiporModel(cfg, device=device)
    model.load_state_dict(params)

    # 1) encode corpus with the (untrained or pretrained) dense encoder
    embs = stage_encode_corpus(ws, model, docs, tok, max_length=64,
                               batch_size=batch_size)
    # 2) RQ DocIDs + install codebooks into the decoder head
    codes = stage_build_docids(ws, embs, docs.ids, M=cfg.M, K=cfg.K,
                               device=device)
    params = stage_install_codebooks(ws, params)
    # 3) seq2seq training: provided pseudo-queries, else qrel pairs
    if s2s_examples_path is None:
        s2s_examples_path = str(ws.path("s2s_from_qrel.jsonl"))
        if not ws.has("s2s_from_qrel.jsonl"):
            with open(s2s_examples_path, "w") as f:
                for qid, rels in qrel.items():
                    for did, r in rels.items():
                        if r > 0:
                            f.write(json.dumps(
                                {"docid": did, "query": queries[qid]}) + "\n")
    examples = Seq2SeqExamples(s2s_examples_path)
    d2c = {d: c for d, c in zip(docs.ids, codes)}
    coll = Seq2SeqCollator(tok, d2c, max_length=32)
    tcfg = TrainConfig(loss_type="t5seq_aq_encoder_seq2seq",
                       learning_rate=learning_rate,
                       total_steps=max(1, s2s_epochs
                                       * max(1, len(examples) // batch_size)))
    batches = batches_from_seq2seq(examples, coll,
                                   batch_size=min(batch_size, len(examples)),
                                   epochs=s2s_epochs, drop_last=False)
    params = stage_train(ws, "final", model, params, tcfg, batches, cfg,
                         rng_seed=seed)
    # 4) trie + retrieval + metrics
    trie = stage_build_trie(ws, codes, cfg.K)
    retriever = RiporModel(cfg, dtype=torch.bfloat16, device=device)
    retriever.load_state_dict(params)
    run = stage_retrieve(ws, cfg, retriever, tok, queries, trie, docs.ids,
                         num_beams=num_beams, topk=topk)
    return stage_evaluate(ws, run, qrel)


def run_train_from_config(cfg_dict: Dict, device=None
                          ) -> Dict[str, torch.Tensor]:
    """Generic one-phase training job (reference main.py:34-190 dispatch);
    returns the trained params (a state_dict of CPU tensors), saved to
    ``workspace/checkpoints/<phase_name>``. Trains in float32 on
    ``device`` (default "cuda", which raises without CUDA).

    loss_type selects the (model, dataset, collator) family:
      t5seq_aq_encoder_{margin_mse,lng_knp_margin_mse,ranknet} — RiporModel
        + a teacher-score trainset (reference MarginMSEforT5SeqAQ*)
      t5seq_aq_encoder_seq2seq — RiporModel + a {"docid","query"} JSONL
      t5seq_pretrain_margin_mse / margin_mse / kldiv — doc-text pairs
        (PretrainCollator; with ``prefix_len`` the docs' smtid prefixes
        and the commit loss; margin_mse/kldiv train the T5DenseEncoder
        baseline, reference t5model_encoder.py)
      t5seq_bce / bert_bce — the cross-encoder teachers (T5SeqCrossEncoder,
        BertCrossEncoder) on a bce_examples TSV (reference
        marco_train_t5seq_cross_encoder.sh)

    Keys: workspace, queries_dir, loss_type, examples_path (docs_dir for
    pretraining, the dense baselines and bert_bce); optional model_config
    (a RiporConfig JSON; default a 4+4-layer d_model 256 model with M, K,
    vocab_size), bert_geometry (BertCrossEncoder kwargs; the vocabulary is
    the tokenizer's), init_checkpoint (params.pt or the JAX package's
    Orbax tree), batch_size, epochs, max_length, seed (of the initial
    params), learning_rate, total_steps, grad_accum, smtid_as_docid,
    prefix_len, phase_name. As in the JAX package, no bert_geometry.json
    is written beside a bert_bce checkpoint (ROADMAP.md Queue 3)."""
    device = resolve_device(device)
    ws = Workspace(cfg_dict["workspace"])
    tok = load_tokenizer(ws.path("tokenizer.json"))
    queries = Collection(cfg_dict["queries_dir"])
    loss_type = cfg_dict["loss_type"]
    batch_size = cfg_dict.get("batch_size", 64)
    epochs = cfg_dict.get("epochs", 1)
    max_length = cfg_dict.get("max_length", 64)
    seed = cfg_dict.get("seed", 0)

    d2c = None
    if ws.has("docid_to_smtid.json"):
        docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
        d2c = dict(zip(docids, codes))

    def ripor_cfg() -> RiporConfig:
        return (RiporConfig.load(cfg_dict["model_config"])
                if "model_config" in cfg_dict else _small_cfg(
                    cfg_dict.get("M", 32), cfg_dict.get("K", 256),
                    cfg_dict.get("vocab_size", tok.vocab_size)))

    model_cfg = None
    if loss_type == "bert_bce":
        model = BertCrossEncoder(vocab_size=tok.vocab_size, device=device,
                                 **cfg_dict.get("bert_geometry", {}))
        docs = Collection(cfg_dict["docs_dir"])
        coll = BertBceCollator(tok, queries, docs, max_length=max_length)
        batches = batches_from_bce(BceExamples(cfg_dict["examples_path"]),
                                   coll, batch_size, epochs=epochs)
    elif loss_type == "t5seq_bce":
        model_cfg = ripor_cfg()
        model = T5SeqCrossEncoder(model_cfg, device=device)
        coll = T5SeqBceCollator(tok, queries, d2c, max_length=max_length)
        batches = batches_from_bce(BceExamples(cfg_dict["examples_path"]),
                                   coll, batch_size, epochs=epochs)
    elif loss_type in ("margin_mse", "kldiv", "t5seq_pretrain_margin_mse"):
        model_cfg = ripor_cfg()
        docs = Collection(cfg_dict["docs_dir"])
        examples = TeacherScoreExamples(cfg_dict["examples_path"])
        if loss_type == "t5seq_pretrain_margin_mse":
            model = RiporModel(model_cfg, device=device)
            prefix_len = cfg_dict.get("prefix_len", 0)
            coll = PretrainCollator(tok, queries, docs, max_length=max_length,
                                    docid_to_codes=d2c if prefix_len else None,
                                    prefix_len=prefix_len)
        else:
            model = T5DenseEncoder(model_cfg.t5, device=device)
            coll = PretrainCollator(tok, queries, docs, max_length=max_length)
        batches = batches_from_teacher_examples(examples, coll, batch_size,
                                                epochs=epochs)
    elif loss_type == "t5seq_aq_encoder_seq2seq":
        model_cfg = ripor_cfg()
        model = RiporModel(model_cfg, device=device)
        examples = Seq2SeqExamples(cfg_dict["examples_path"])
        coll = Seq2SeqCollator(tok, d2c, max_length=max_length)
        batches = batches_from_seq2seq(examples, coll, batch_size,
                                       epochs=epochs)
    else:
        model_cfg = ripor_cfg()
        model = RiporModel(model_cfg, device=device)
        smtid_as_docid = cfg_dict.get("smtid_as_docid", False)
        examples = TeacherScoreExamples(cfg_dict["examples_path"],
                                        smtid_as_docid=smtid_as_docid)
        prefix = examples.prefix_lengths_present() \
            if loss_type == "t5seq_aq_encoder_lng_knp_margin_mse" else ()
        coll = MarginMSECollator(tok, queries, d2c, max_length=max_length,
                                 smtid_as_docid=smtid_as_docid,
                                 prefix_lengths=prefix)
        batches = batches_from_teacher_examples(examples, coll, batch_size,
                                                epochs=epochs)

    if "init_checkpoint" in cfg_dict:
        params = load_params(cfg_dict["init_checkpoint"], model_cfg,
                             model=model)
    else:
        params = init_params(model,
                             torch.Generator(device=device).manual_seed(seed),
                             device=device)
    tcfg = TrainConfig(loss_type=loss_type,
                       learning_rate=cfg_dict.get("learning_rate", 1e-4),
                       total_steps=cfg_dict.get("total_steps", 100_000),
                       grad_accum=cfg_dict.get("grad_accum", 1))
    return stage_train(ws, cfg_dict.get("phase_name", loss_type), model,
                       params, tcfg, batches, model_cfg)
