"""Dense-encoder baselines, in PyTorch.

Port of ripor_tpu/models/dense_encoder.py:

* ``T5DenseEncoder`` — plain T5 dense encoder: rep = decoder hidden at
  position 0 given a learned start embedding (reference T5ModelEncoder,
  modeling/t5model_encoder.py:11-99), with its MarginMSE and KLDiv
  training losses (``t5_dense_margin_mse``, ``t5_dense_kldiv``).
* ``BertDenseEncoder`` — BERT-style CLS encoder (reference DenseEncoder,
  modeling/dense_encoder.py:5-11).

A loss takes ``(model, batch, train, generator)`` as train/losses.py's do;
each of its three forwards replays the generator's state, as the JAX loss
hands one dropout rng to each model.apply.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ripor_tpu_torch.models.bert import BertBackbone, BertConfig
from ripor_tpu_torch.models.config import T5Config
from ripor_tpu_torch.models.layers import replay
from ripor_tpu_torch.models.t5 import Decoder, Encoder


class T5DenseEncoder(nn.Module):
    """T5 encoder-decoder with its own ``shared`` table, ``encoder``,
    ``decoder`` and ``start_embed``; (ids, mask) -> rep [B, d]."""

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.start_embed = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.requires_grad_(False)

    def forward(self, input_ids, attention_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        enc = self.encoder(self.shared(input_ids), attention_mask,
                           deterministic=deterministic, generator=generator)
        start = self.start_embed[None, None, :].expand(
            input_ids.shape[0], 1, -1)
        hidden = self.decoder(start, enc, attention_mask,
                              deterministic=deterministic, generator=generator)
        return hidden[:, 0, :]


def _reps(model, batch: Dict, train: bool, generator):
    """float32 reps of the batch's queries, positive and negative docs."""
    def rep(ids, mask):
        return model(ids, mask, deterministic=not train,
                     generator=replay(generator)).float()
    return (rep(batch["query_ids"], batch["query_mask"]),
            rep(batch["pos_doc_ids"], batch["pos_doc_mask"]),
            rep(batch["neg_doc_ids"], batch["neg_doc_mask"]))


def t5_dense_margin_mse(model, batch: Dict, train: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
    """MarginMSE for the dense baseline (reference
    t5model_encoder.py:36-62)."""
    q, pd, nd = _reps(model, batch, train, generator)
    margin = (q * pd).sum(-1) - (q * nd).sum(-1)
    teacher = (batch["teacher_pos_score"]
               - batch["teacher_neg_score"]).float()
    return {"rank": ((margin - teacher) ** 2).mean()}


def t5_dense_kldiv(model, batch: Dict, train: bool = True,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """KLDiv over the (pos, neg) score distributions against the
    teacher's (reference T5ModelEncoderForKLDiv,
    t5model_encoder.py:64-99)."""
    q, pd, nd = _reps(model, batch, train, generator)
    student = torch.stack([(q * pd).sum(-1), (q * nd).sum(-1)], dim=1)
    teacher = torch.stack([batch["teacher_pos_score"],
                           batch["teacher_neg_score"]], dim=1).float()
    s_logp = torch.log_softmax(student, dim=1)
    t_p = torch.softmax(teacher, dim=1)
    return {"rank": (t_p * (torch.log(t_p + 1e-9) - s_logp)).sum(1).mean()}


class BertDenseEncoder(nn.Module):
    """CLS-pooled BERT-style encoder (reference dense_encoder.py:5-11:
    AutoModel last_hidden_state[:, 0]); bert-base geometry by default,
    with the T5 vocabulary size as the JAX module has it. HF-parity
    backbone: pretrained BERT weights load through
    import_hf.hf_bert_to_params."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12, d_ff: int = 3072,
                 max_position: int = 512, dropout: float = 0.1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = BertConfig(vocab_size=vocab_size, d_model=d_model,
                              num_layers=num_layers, num_heads=num_heads,
                              d_ff=d_ff, max_position=max_position,
                              dropout=dropout)
        self.dtype = dtype
        self.bert = BertBackbone(self.cfg, dtype=dtype, device=device)
        self.requires_grad_(False)

    def forward(self, input_ids, attention_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        return self.bert(input_ids, attention_mask,
                         deterministic=deterministic, generator=generator)[:, 0]
