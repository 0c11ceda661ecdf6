"""Training losses, in PyTorch: each returns a dict of named float32
scalars (the contract the trainer sums with per-task weights; reference
arguments.py:109-141 sets all weights 1.0, tasks/trainer.py:232-243 does
the weighted sum).

Port of ripor_tpu/train/losses.py. Loss map (reference -> here):
  T5SeqPretrainEncoder.forward      (t5_generative_retriever.py:708-769) -> pretrain_margin_mse
  T5SeqAQEncoderForMarginMSE        (:863-884)                            -> margin_mse
  T5SeqAQEncoderForSeq2Seq          (:999-1019)                           -> seq2seq_ce
  T5SeqAQEncoderForLngKnpMarginMSE  (:908-966)                            -> lng_knp_margin_mse
  CrossEncoder / T5SeqCrossEncoder  (cross_encoder.py:17-23, 75-92)       -> bert_bce, t5seq_bce
  T5ModelEncoder(ForKLDiv)          (t5model_encoder.py:36-99)            -> margin_mse, kldiv
                                                                             (LOSS_FNS keys; models/dense_encoder.py)
A loss takes ``(model, batch, train, generator)``: batches are dicts of
fixed-shape tensors on the model's device, ``generator`` the dropout
generator of the step (used when ``train``).

Dropout masks: each JAX loss hands one dropout rng to every model.apply it
makes, so every forward of one loss call draws the same masks wherever
the shapes agree. Here every forward starts from a copy of the
generator's state (``_replay``), which keeps that property. It also lets
one encoder pass serve the forwards that share a query (their encoder
passes are the same function), with each decoder pass replaying the
generator's state after it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ripor_tpu_torch.models.cross_encoder import bce_loss
from ripor_tpu_torch.models.dense_encoder import (t5_dense_kldiv,
                                                  t5_dense_margin_mse)
from ripor_tpu_torch.models.layers import replay as _replay
from ripor_tpu_torch.models.ripor import RiporModel


def _query_hiddens(model: RiporModel, batch: Dict, train: bool, generator,
                   *codes):
    """Decoder hidden states of the batch's queries for each codes [B, m],
    over one encoder pass; each decoder pass replays the generator's
    state after the encoder, as a full forward would reach it."""
    mask = batch["query_mask"]
    g = _replay(generator)
    enc = model.encode(batch["query_ids"], mask, deterministic=not train,
                       generator=g)
    return [model.decode_train(enc, mask, c, deterministic=not train,
                               generator=_replay(g)) for c in codes]


def _seq_dot(q_hidden: torch.Tensor, d_embeds: torch.Tensor) -> torch.Tensor:
    """Sequential dot-product score sum_i <q_i, d_i> -> [B] fp32."""
    return (q_hidden.float() * d_embeds.float()).sum(dim=(-2, -1))


def _teacher_margin(batch: Dict, pos: str, neg: str) -> torch.Tensor:
    return (batch[pos] - batch[neg]).float()


def margin_mse(model: RiporModel, batch: Dict, train: bool = True,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """MarginMSE on sequential dot scores vs teacher margin
    (reference :863-884). Batch:
      query_ids/query_mask [B, L]; pos_codes/neg_codes [B, m];
      teacher_pos_score/teacher_neg_score [B]."""
    pos_hidden, neg_hidden = _query_hiddens(
        model, batch, train, generator, batch["pos_codes"],
        batch["neg_codes"])
    student = (_seq_dot(pos_hidden, model.doc_embeds(batch["pos_codes"]))
               - _seq_dot(neg_hidden, model.doc_embeds(batch["neg_codes"])))
    teacher = _teacher_margin(batch, "teacher_pos_score",
                              "teacher_neg_score")
    return {"rank": ((student - teacher) ** 2).mean()}


def seq2seq_ce(model: RiporModel, batch: Dict, train: bool = True,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """Per-position cross-entropy over the K-way codebook logits
    (reference :999-1019: flat CE over [B*m, K] with labels=codes).
    Batch: query_ids/query_mask [B, L]; codes [B, m]."""
    logits = model.forward_logits(batch["query_ids"], batch["query_mask"],
                                  batch["codes"], deterministic=not train,
                                  generator=_replay(generator))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(2, batch["codes"].long()[:, :, None])[:, :, 0]
    return {"rank": nll.mean()}


def lng_knp_margin_mse(model: RiporModel, batch: Dict, train: bool = True,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
    """Prefix-oriented multi-objective MarginMSE (the paper's key loss;
    reference :908-966): full-length margin plus margins over prefixes
    4/8/(16) against prefix-specific teacher scores.

    Batch: as margin_mse plus smtid_{4,8,16}_teacher_{pos,neg}_score
    (which keys are present depends on m: m=8 -> 4; m=16 -> 4,8;
    m=32 -> 4,8,16 — reference :942-962)."""
    pos_hidden, neg_hidden = _query_hiddens(
        model, batch, train, generator, batch["pos_codes"],
        batch["neg_codes"])
    # per-position partial products let every prefix loss reuse one forward
    pos_dots = (pos_hidden.float()
                * model.doc_embeds(batch["pos_codes"]).float()).sum(-1)
    neg_dots = (neg_hidden.float()
                * model.doc_embeds(batch["neg_codes"]).float()).sum(-1)

    m = batch["pos_codes"].shape[1]
    student = pos_dots.sum(-1) - neg_dots.sum(-1)
    teacher = _teacher_margin(batch, "teacher_pos_score",
                              "teacher_neg_score")
    losses = {"rank": ((student - teacher) ** 2).mean()}
    for plen in (4, 8, 16):
        key = f"smtid_{plen}_teacher_pos_score"
        if plen >= m or key not in batch:
            continue
        s = pos_dots[:, :plen].sum(-1) - neg_dots[:, :plen].sum(-1)
        t = _teacher_margin(batch, key, f"smtid_{plen}_teacher_neg_score")
        losses[f"rank_{plen}"] = ((s - t) ** 2).mean()
    return losses


def lng_knp_margin_mse_and_seq2seq(model: RiporModel, batch: Dict,
                                   train: bool = True,
                                   generator: Optional[torch.Generator]
                                   = None) -> Dict[str, torch.Tensor]:
    """Joint prefix-rank + seq2seq loss (the reference declares
    ``t5seq_aq_encoder_lng_knp_margin_mse_and_seq2seq``, arguments.py:97,
    but never shipped its model class): lng_knp MarginMSE on the rank keys
    plus codebook CE on an independently drawn seq2seq sub-batch (keys
    prefixed ``s2s_``, built by ``batches_from_joint``)."""
    out = lng_knp_margin_mse(model, batch, train, generator)
    s2s = {"query_ids": batch["s2s_query_ids"],
           "query_mask": batch["s2s_query_mask"],
           "codes": batch["s2s_codes"]}
    out["seq2seq"] = seq2seq_ce(model, s2s, train, generator)["rank"]
    return out


def pretrain_margin_mse(model: RiporModel, batch: Dict, train: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
    """Phase-1 dense-encoder MarginMSE (reference :708-769): score =
    <query dense rep, doc dense rep> where reps are decoder hidden at the
    last input position; optional codebook-commitment CE when a smtid
    prefix is present (:617-670).

    Batch: query_ids/query_mask, pos_doc_ids/pos_doc_mask,
    neg_doc_ids/neg_doc_mask, teacher_pos_score, teacher_neg_score;
    optional pos_prefix_codes/neg_prefix_codes [B, p] (prefix-conditioned
    stage with commit loss)."""
    has_prefix = "pos_prefix_codes" in batch

    def reps(ids, mask, codes):
        # hidden over [start] + prefix; last position is the dense rep
        return model(ids, mask, codes, deterministic=not train,
                     generator=_replay(generator))

    if has_prefix:
        # decoder inputs: [start, c1..cp] -> hidden length p+1 (the model
        # consumes target codes, so a dummy target slot is appended)
        def with_start(prefix):
            return torch.cat([prefix, torch.zeros_like(prefix[:, :1])], 1)
        pos_codes = with_start(batch["pos_prefix_codes"])
        neg_codes = with_start(batch["neg_prefix_codes"])
        pq, nq = _query_hiddens(model, batch, train, generator, pos_codes,
                                neg_codes)
    else:
        pos_codes = torch.zeros(batch["query_ids"].shape[0], 1,
                                dtype=torch.int32,
                                device=batch["query_ids"].device)
        neg_codes = pos_codes
        pq = nq = reps(batch["query_ids"], batch["query_mask"], pos_codes)
    pd = reps(batch["pos_doc_ids"], batch["pos_doc_mask"], pos_codes)
    nd = reps(batch["neg_doc_ids"], batch["neg_doc_mask"], neg_codes)

    pos_s = (pq[:, -1].float() * pd[:, -1].float()).sum(-1)
    neg_s = (nq[:, -1].float() * nd[:, -1].float()).sum(-1)
    teacher = _teacher_margin(batch, "teacher_pos_score",
                              "teacher_neg_score")
    out = {"rank": (((pos_s - neg_s) - teacher) ** 2).mean()}

    if has_prefix:
        # commitment CE: prefix-position hidden states should select the
        # prefix codes from the codebooks (reference get_commit_loss
        # :617-670, applied to pos doc, neg doc, and pos query reps)
        p = batch["pos_prefix_codes"].shape[1]
        commit = 0.0
        for hidden, labels in ((pd, batch["pos_prefix_codes"]),
                               (nd, batch["neg_prefix_codes"]),
                               (pq, batch["pos_prefix_codes"])):
            logp = torch.log_softmax(model.lm_logits(hidden[:, :p]), dim=-1)
            commit = commit - logp.gather(2, labels.long()[:, :, None]).mean()
        out["commit"] = commit
    return out


def ranknet(model: RiporModel, batch: Dict, train: bool = True,
            generator: Optional[torch.Generator] = None
            ) -> Dict[str, torch.Tensor]:
    """RankNet pairwise loss on sequential dot scores (reference
    t5seq_aq_encoder_ranknet loss_type; losses/pairwise.py:3-45)."""
    pos_hidden, neg_hidden = _query_hiddens(
        model, batch, train, generator, batch["pos_codes"],
        batch["neg_codes"])
    pos = _seq_dot(pos_hidden, model.doc_embeds(batch["pos_codes"]))
    neg = _seq_dot(neg_hidden, model.doc_embeds(batch["neg_codes"]))
    return {"rank": torch.log1p(torch.exp(-(pos - neg))).mean()}


def t5seq_bce(model, batch: Dict, train: bool = True,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """BCE classification for the T5SeqCrossEncoder teacher (reference
    loss_type=t5seq_bce; modeling/cross_encoder.py:75-92). Batch:
    query_ids/query_mask [B, L]; codes [B, m]; labels [B] in {0, 1}."""
    logits = model(batch["query_ids"], batch["query_mask"], batch["codes"],
                   deterministic=not train, generator=_replay(generator))
    return {"cls": bce_loss(logits, batch["labels"])}


def bert_bce(model, batch: Dict, train: bool = True,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """BCE classification for the BERT cross-encoder teacher (reference
    CrossEncoder.forward, modeling/cross_encoder.py:17-23, loss_type=
    bert_bce). Batch: input_ids/attention_mask [B, L]; optional
    token_type_ids; labels [B] in {0, 1}."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   batch.get("token_type_ids"), deterministic=not train,
                   generator=_replay(generator))
    return {"cls": bce_loss(logits, batch["labels"])}


LOSS_FNS = {
    "t5seq_aq_encoder_margin_mse": margin_mse,
    "t5seq_aq_encoder_seq2seq": seq2seq_ce,
    "t5seq_aq_encoder_lng_knp_margin_mse": lng_knp_margin_mse,
    "t5seq_aq_encoder_lng_knp_margin_mse_and_seq2seq":
        lng_knp_margin_mse_and_seq2seq,
    "t5seq_pretrain_margin_mse": pretrain_margin_mse,
    "t5seq_aq_encoder_ranknet": ranknet,
    # teacher / baseline families (reference arguments.py:81-100 whitelist
    # names): the trainer is model-agnostic — pass the matching model
    "t5seq_bce": t5seq_bce,
    "bert_bce": bert_bce,
    "margin_mse": t5_dense_margin_mse,   # T5DenseEncoder baseline
    "kldiv": t5_dense_kldiv,             # T5DenseEncoder (KLDiv) baseline
}
