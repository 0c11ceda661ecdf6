"""Cross-encoder teachers, in PyTorch.

Port of ripor_tpu/models/cross_encoder.py, mirroring the reference
(modeling/cross_encoder.py):

* ``BertCrossEncoder`` — BERT-style (query, doc) pair scorer with a pooled
  CLS classification head (HF BertForSequenceClassification(num_labels=1)
  semantics, so converted MiniLM weights load through
  models/import_hf.py::hf_bert_to_params; trained with ``bert_bce``).
* ``T5SeqCrossEncoder`` — the RIPOR backbone scoring (query, smtid) pairs:
  decoder hidden states over the smtid positions, mean-pooled into a tanh
  classification head (trained with ``t5seq_bce``).

Weights are allocated uninitialized on ``device``; fill them with
``load_state_dict`` (models/convert.py: ``init_params`` or
``params_from_jax``). Parameters do not require grad until a trainer turns
it on. ``generator``: the dropout generator, as in models/t5.py.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ripor_tpu_torch.models.bert import BertBackbone, BertConfig
from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.ripor import RiporModel
from ripor_tpu_torch.models.t5 import _dropout_seeds, _seeded_dropout


class BertCrossEncoder(nn.Module):
    """(query ++ [SEP] ++ doc) token sequence -> relevance logit [B]
    (float32): backbone -> pooler (dense + tanh on CLS) -> dropout ->
    classifier. MiniLM-L6 geometry by default, with the T5 vocabulary
    size (32128) as the JAX module has it."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 384,
                 num_layers: int = 6, num_heads: int = 12, d_ff: int = 1536,
                 max_position: int = 512, dropout: float = 0.1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = BertConfig(vocab_size=vocab_size, d_model=d_model,
                              num_layers=num_layers, num_heads=num_heads,
                              d_ff=d_ff, max_position=max_position,
                              dropout=dropout)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.bert = BertBackbone(self.cfg, **kw)
        self.pooler = nn.Linear(d_model, d_model, **kw)
        self.classifier = nn.Linear(d_model, 1, **kw)
        self.requires_grad_(False)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        rate = self.cfg.dropout
        x = self.bert(input_ids, attention_mask, token_type_ids,
                      deterministic=deterministic, generator=generator)
        seed, = _dropout_seeds(1, rate, deterministic, generator)
        cls = _seeded_dropout(torch.tanh(self.pooler(x[:, 0])), rate, seed)
        return self.classifier(cls)[:, 0].float()


class T5ClassificationHead(nn.Module):
    """dropout -> dense -> tanh -> dropout -> out_proj -> [B] float32
    (reference :39-54). The flax submodules are the unnamed ``Dense_0``
    and ``Dense_1``, and so are these."""

    def __init__(self, d_model: int, dropout: float = 0.1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.rate = dropout
        self.Dense_0 = nn.Linear(d_model, d_model, dtype=dtype, device=device)
        self.Dense_1 = nn.Linear(d_model, 1, dtype=dtype, device=device)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        seeds = _dropout_seeds(2, self.rate, deterministic, generator)
        x = torch.tanh(self.Dense_0(_seeded_dropout(x, self.rate, seeds[0])))
        x = _seeded_dropout(x, self.rate, seeds[1])
        return self.Dense_1(x)[:, 0].float()


class T5SeqCrossEncoder(nn.Module):
    """(query tokens, smtid codes) -> relevance logit [B] (reference
    :57-92): the RiporModel's decoder hidden [B, m, d] mean-pooled into
    the head."""

    def __init__(self, cfg: RiporConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.base = RiporModel(cfg, dtype=dtype, device=device)
        self.head = T5ClassificationHead(cfg.t5.d_model, cfg.t5.dropout_rate,
                                         dtype=dtype, device=device)
        self.requires_grad_(False)

    def forward(self, input_ids, attention_mask, codes,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        hidden = self.base(input_ids, attention_mask, codes,
                           deterministic=deterministic, generator=generator)
        return self.head(hidden.mean(dim=1), deterministic=deterministic,
                         generator=generator)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BCEWithLogits (reference cls_loss): mean over the batch, float32."""
    logits = logits.float()
    labels = labels.float()
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()
