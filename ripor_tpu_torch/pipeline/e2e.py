"""The generic one-phase trainer behind the ``train`` CLI, in PyTorch.

Port of ripor_tpu/pipeline/e2e.py's ``run_train_from_config`` (reference:
t5_pretrainer/main.py) for the RiporModel loss families; ``run_e2e``
waits for the pipeline slice (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

from typing import Dict

import torch

from ripor_tpu_torch.data.collators import (
    MarginMSECollator,
    PretrainCollator,
    Seq2SeqCollator,
    batches_from_seq2seq,
    batches_from_teacher_examples,
)
from ripor_tpu_torch.data.datasets import (Collection, Seq2SeqExamples,
                                           TeacherScoreExamples,
                                           load_docid_to_smtid)
from ripor_tpu_torch.decode.beam import resolve_device
from ripor_tpu_torch.models.config import RiporConfig, T5Config
from ripor_tpu_torch.models.convert import init_params
from ripor_tpu_torch.models.ripor import RiporModel
from ripor_tpu_torch.pipeline.recipe import (Workspace, load_tokenizer,
                                             stage_train)
from ripor_tpu_torch.train.checkpoint import load_params
from ripor_tpu_torch.train.losses import NOT_PORTED
from ripor_tpu_torch.train.trainer import TrainConfig


def _small_cfg(M: int, K: int, vocab_size: int) -> RiporConfig:
    return RiporConfig(
        t5=T5Config(vocab_size=vocab_size, d_model=256, d_kv=32, d_ff=1024,
                    num_layers=4, num_decoder_layers=4, num_heads=8,
                    dropout_rate=0.1),
        M=M, K=K)


def run_train_from_config(cfg_dict: Dict, device=None
                          ) -> Dict[str, torch.Tensor]:
    """Generic one-phase training job (reference main.py:34-190 dispatch);
    returns the trained params (a state_dict of CPU tensors), saved to
    ``workspace/checkpoints/<phase_name>``. Trains in float32 on
    ``device`` (default "cuda", which raises without CUDA).

    loss_type selects the (dataset, collator) family:
      t5seq_aq_encoder_{margin_mse,lng_knp_margin_mse,ranknet} — a
        teacher-score trainset (reference MarginMSEforT5SeqAQ*)
      t5seq_aq_encoder_seq2seq — a {"docid","query"} JSONL
      t5seq_pretrain_margin_mse — doc-text pairs (PretrainCollator; with
        ``prefix_len`` the docs' smtid prefixes and the commit loss)
    The teacher and baseline families (NOT_PORTED) raise.

    Keys: workspace, queries_dir, loss_type, examples_path (docs_dir for
    pretraining); optional model_config (a RiporConfig JSON; default a
    4+4-layer d_model 256 model with M, K, vocab_size), init_checkpoint
    (params.pt or the JAX package's Orbax tree), batch_size, epochs,
    max_length, seed (of the initial params), learning_rate, total_steps,
    grad_accum, smtid_as_docid, prefix_len, phase_name."""
    loss_type = cfg_dict["loss_type"]
    if loss_type in NOT_PORTED:
        raise NotImplementedError(
            f"loss_type {loss_type!r} trains a teacher or dense-baseline "
            "model, which ripor_tpu_torch does not port yet (ROADMAP.md "
            "Queue 1 item 9)")
    device = resolve_device(device)
    ws = Workspace(cfg_dict["workspace"])
    tok = load_tokenizer(ws.path("tokenizer.json"))
    queries = Collection(cfg_dict["queries_dir"])
    batch_size = cfg_dict.get("batch_size", 64)
    epochs = cfg_dict.get("epochs", 1)
    max_length = cfg_dict.get("max_length", 64)
    seed = cfg_dict.get("seed", 0)

    d2c = None
    if ws.has("docid_to_smtid.json"):
        docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
        d2c = dict(zip(docids, codes))
    model_cfg = (RiporConfig.load(cfg_dict["model_config"])
                 if "model_config" in cfg_dict else _small_cfg(
                     cfg_dict.get("M", 32), cfg_dict.get("K", 256),
                     cfg_dict.get("vocab_size", tok.vocab_size)))

    if loss_type == "t5seq_pretrain_margin_mse":
        docs = Collection(cfg_dict["docs_dir"])
        examples = TeacherScoreExamples(cfg_dict["examples_path"])
        prefix_len = cfg_dict.get("prefix_len", 0)
        coll = PretrainCollator(tok, queries, docs, max_length=max_length,
                                docid_to_codes=d2c if prefix_len else None,
                                prefix_len=prefix_len)
        batches = batches_from_teacher_examples(examples, coll, batch_size,
                                                epochs=epochs)
    elif loss_type == "t5seq_aq_encoder_seq2seq":
        examples = Seq2SeqExamples(cfg_dict["examples_path"])
        coll = Seq2SeqCollator(tok, d2c, max_length=max_length)
        batches = batches_from_seq2seq(examples, coll, batch_size,
                                       epochs=epochs)
    else:
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

    model = RiporModel(model_cfg, device=device)
    if "init_checkpoint" in cfg_dict:
        params = load_params(cfg_dict["init_checkpoint"], model_cfg)
    else:
        params = init_params(model_cfg,
                             torch.Generator(device=device).manual_seed(seed),
                             device=device)
    tcfg = TrainConfig(loss_type=loss_type,
                       learning_rate=cfg_dict.get("learning_rate", 1e-4),
                       total_steps=cfg_dict.get("total_steps", 100_000),
                       grad_accum=cfg_dict.get("grad_accum", 1))
    return stage_train(ws, cfg_dict.get("phase_name", loss_type), model,
                       params, tcfg, batches, model_cfg)
