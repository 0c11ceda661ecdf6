"""BERT trunk in PyTorch, with HF weight-import parity.

Port of ripor_tpu/models/bert.py: biased Q/K/V/O projections, q divided
by sqrt(d_head) in the model dtype before the q.k product, float32 scores
and softmax (the probabilities cast back to the model dtype), post-norm
residuals with a biased LayerNorm (eps 1e-12), learned absolute position
and token-type embeddings, and the exact (erf) GELU — HF BERT's numerics,
so converted HF weights (models/import_hf.py::hf_bert_to_params) reproduce
its outputs. The T5 stack's tanh GELU (models/layers.py) is not reused.

Dropout falls after the embeddings' norm, after attention and after the
FFN, as in the flax module (no attention-probability dropout). As in
models/t5.py, the backbone draws one seed a layer from the caller's
``generator`` and each layer draws its masks from a generator on the
activations' device seeded with it.

Parameter names mirror the flax tree (``layer_<i>`` -> ``layers.<i>``;
LayerNorm ``scale``/``bias`` stay float32, as flax keeps its params).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from ripor_tpu_torch.models.layers import NEG_INF, _empty, dropout
from ripor_tpu_torch.models.t5 import _dropout_seeds, _seeded, _seeded_dropout


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Geometry of a BERT-family encoder (HF BertConfig subset).

    Defaults are MiniLM-L6 (the reference's cross-encoder teacher,
    cross-encoder/ms-marco-MiniLM-L-6-v2)."""

    vocab_size: int = 30522
    d_model: int = 384
    num_layers: int = 6
    num_heads: int = 12
    d_ff: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12

    @classmethod
    def minilm_l6(cls) -> "BertConfig":
        return cls()

    @classmethod
    def bert_base(cls) -> "BertConfig":
        return cls(d_model=768, num_layers=12, num_heads=12, d_ff=3072)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: mean and variance over the last axis in
    float32, float32 ``scale`` and ``bias``, the result in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = _empty((dim,), torch.float32, device)
        self.bias = _empty((dim,), torch.float32, device)

    def forward(self, x):
        return Fn.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias,
                             self.eps).to(self.dtype)


def _dense(fan_in, fan_out, dtype, device):
    return nn.Linear(fan_in, fan_out, bias=True, dtype=dtype, device=device)


class BertSelfAttention(nn.Module):
    """Scaled dot-product MHA with biased projections (HF BertSelfAttention
    + BertSelfOutput dense, without the residual/LN which live in
    BertLayer)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.d_model
        self.q = _dense(d, d, dtype, device)
        self.k = _dense(d, d, dtype, device)
        self.v = _dense(d, d, dtype, device)
        self.o = _dense(d, d, dtype, device)

    def forward(self, x, bias):
        cfg = self.cfg
        b, l, _ = x.shape
        d_head = cfg.d_model // cfg.num_heads

        def split(t):
            return t.reshape(b, l, cfg.num_heads, d_head)
        q = split(self.q(x)) / torch.tensor(d_head ** 0.5, dtype=self.dtype)
        k = split(self.k(x))
        v = split(self.v(x))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(scores + bias.float(), dim=-1).to(self.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o(attn.reshape(b, l, cfg.d_model))


class BertLayer(nn.Module):
    """Post-norm transformer encoder layer (BERT convention; HF
    BertLayer)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.rate = cfg.dropout
        self.attn = BertSelfAttention(cfg, **kw)
        self.attn_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, **kw)
        self.ffn_wi = _dense(cfg.d_model, cfg.d_ff, **kw)
        self.ffn_wo = _dense(cfg.d_ff, cfg.d_model, **kw)
        self.ffn_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, **kw)

    def forward(self, x, bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        def drop(h):
            return dropout(h, self.rate, deterministic, generator)
        x = self.attn_norm(x + drop(self.attn(x, bias)))
        h = self.ffn_wo(Fn.gelu(self.ffn_wi(x)))   # exact (erf) gelu
        return self.ffn_norm(x + drop(h))


class BertBackbone(nn.Module):
    """Embeddings + encoder stack -> last hidden states [B, L, d].

    Mirrors HF BertModel minus the pooler (the heads that need it hold
    it). token_type_ids default to zeros (single segment)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.word = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.position = nn.Embedding(cfg.max_position, cfg.d_model, **kw)
        self.type = nn.Embedding(cfg.type_vocab_size, cfg.d_model, **kw)
        self.emb_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(BertLayer(cfg, **kw)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        # "type" is the flax name; as an attribute it is Module.type
        types = self._modules["type"]
        x = (self.word(input_ids) + self.position(pos)[None]
             + types(token_type_ids.long()))
        seeds = _dropout_seeds(len(self.layers) + 1, cfg.dropout,
                               deterministic, generator)
        x = _seeded_dropout(self.emb_norm(x), cfg.dropout, seeds[0])
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           NEG_INF).float()
        for layer, seed in zip(self.layers, seeds[1:]):
            x = layer(x, bias, deterministic=seed is None,
                      generator=_seeded(seed, x.device))
        return x
