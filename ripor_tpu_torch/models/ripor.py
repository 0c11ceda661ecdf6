"""RiporModel — the generative retriever, in PyTorch.

Port of ripor_tpu/models/ripor.py: a T5 encoder-decoder whose decoder
reads and scores per-position codebooks [M, K, d] (one tensor, so the
per-position heads are one gather / matmul over the position axis).
smtids are pure code arrays [c1..cm] in [0, K); the start token is the
learned ``start_embed``.

The full forwards take ``deterministic`` and a dropout ``generator`` as
the flax methods take ``deterministic`` and a dropout rng (models/t5.py
says how the masks are drawn).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.t5 import CrossKV, Decoder, Encoder


class RiporModel(nn.Module):
    """Weights are allocated uninitialized on ``device``; fill them with
    ``load_state_dict`` (models/convert.py: ``params_from_jax`` or
    ``init_params``). Parameters do not require grad until a trainer
    (train/trainer.py) turns it on."""

    def __init__(self, cfg: RiporConfig, dtype=torch.float32, device=None):
        super().__init__()
        t5 = cfg.t5
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.shared = nn.Embedding(t5.vocab_size, t5.d_model, **kw)
        self.encoder = Encoder(t5, **kw)
        self.decoder = Decoder(t5, **kw)
        self.codebooks = nn.Parameter(
            torch.empty(cfg.M, cfg.K, t5.d_model, **kw))
        if not cfg.shared_output_input_embeds:
            self.output_codebooks = nn.Parameter(
                torch.empty(cfg.M, cfg.K, t5.d_model, **kw))
        self.start_embed = nn.Parameter(torch.empty(t5.d_model, **kw))
        self.requires_grad_(False)

    def _out_books(self):
        return (self.codebooks if self.cfg.shared_output_input_embeds
                else self.output_codebooks)

    # ---- encoder ----

    def encode(self, input_ids, attention_mask, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        """Token ids -> encoder hidden states [B, S, d]."""
        return self.encoder(self.shared(input_ids), attention_mask,
                            deterministic=deterministic, generator=generator)

    # ---- decoder-side embedding / scoring ----

    def decoder_inputs_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """Shift-right decoder inputs for codes [B, m] -> [B, m, d]:
        position 0 is the start embedding, position i > 0 is
        codebooks[i-1, codes[:, i-1]]."""
        b, m = codes.shape
        books = self.codebooks
        pos = torch.arange(m - 1, device=codes.device)[None, :]
        prev = books[pos, codes[:, :m - 1]]               # [B, m-1, d]
        start = self.start_embed[None, None, :].expand(b, 1, -1)
        return torch.cat([start, prev], dim=1)

    def decoder_inputs_from_multi_codes(self, codes: torch.Tensor
                                        ) -> torch.Tensor:
        """Multi-id variant: codes [B, m, G] -> shift-right inputs [B, m, d]
        whose position i > 0 is the mean of the G candidates' embeddings
        codebooks[i-1, codes[:, i-1, g]]."""
        b, m, _ = codes.shape
        pos = torch.arange(m - 1, device=codes.device)[None, :, None]
        prev = self.codebooks[pos, codes[:, :m - 1, :]].mean(dim=2)
        start = self.start_embed[None, None, :].expand(b, 1, -1)
        return torch.cat([start, prev], dim=1)

    def doc_embeds(self, codes: torch.Tensor) -> torch.Tensor:
        """Per-position output embeddings of codes [B, m] -> [B, m, d]."""
        m = codes.shape[1]
        pos = torch.arange(m, device=codes.device)[None, :]
        return self._out_books()[pos, codes]

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [B, m, d] -> float32 logits [B, m, K]."""
        m = hidden.shape[1]
        return torch.einsum("bmd,mkd->bmk", hidden.float(),
                            self._out_books()[:m].float())

    def _maybe_scale(self, hidden):
        if self.cfg.scaleup_output_hidden:
            return hidden * (self.cfg.t5.d_model ** -0.5)
        return hidden

    # ---- full forwards ----

    def forward(self, input_ids, attention_mask, codes,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Seq2seq forward: decoder hidden states [B, m, d]."""
        enc = self.encode(input_ids, attention_mask, deterministic, generator)
        return self.decode_train(enc, attention_mask, codes, deterministic,
                                 generator)

    def decode_train(self, enc, enc_mask, codes, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None):
        """Teacher-forced decoder hidden states [B, m, d] over the encoder
        output ``enc`` for target codes [B, m]."""
        dec_in = self.decoder_inputs_from_codes(codes)
        return self._maybe_scale(self.decoder(dec_in, enc, enc_mask,
                                              deterministic, generator))

    def forward_logits(self, input_ids, attention_mask, codes,
                       deterministic: bool = True,
                       generator: Optional[torch.Generator] = None):
        """Teacher-forced logits [B, m, K] (float32)."""
        return self.lm_logits(self(input_ids, attention_mask, codes,
                                   deterministic, generator))

    def rerank_score(self, input_ids, attention_mask, codes,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None):
        """Sequential dot-product score sum_i <h_i, E[i][c_i]> -> [B]."""
        hidden = self(input_ids, attention_mask, codes, deterministic,
                      generator)
        return (hidden.float() * self.doc_embeds(codes).float()).sum(
            dim=(-2, -1))

    def rerank_score_prefix(self, input_ids, attention_mask, codes, lengths,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None):
        """rerank_score over only the first ``lengths[b]`` positions of the
        padded codes [B, m]; lengths [B]. Returns [B]."""
        hidden = self(input_ids, attention_mask, codes, deterministic,
                      generator)
        per_pos = (hidden.float() * self.doc_embeds(codes).float()).sum(-1)
        pos = torch.arange(codes.shape[1], device=codes.device)[None, :]
        return (per_pos * (pos < lengths[:, None]).float()).sum(-1)

    def dense_rep(self, input_ids, attention_mask, prefix_codes=None,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None):
        """Dense-encoder mode: the decoder hidden state at the last input
        position, after an optional smtid prefix [B, p]. Returns [B, d]."""
        if prefix_codes is None:
            prefix_codes = torch.zeros(input_ids.shape[0], 1,
                                       dtype=torch.int32,
                                       device=input_ids.device)
        return self(input_ids, attention_mask, prefix_codes, deterministic,
                    generator)[:, -1, :]

    def dense_rep_all(self, input_ids, attention_mask, codes,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
        """All decoder positions' hidden states [B, m, d]."""
        return self(input_ids, attention_mask, codes, deterministic,
                    generator)

    # ---- decode path (decode/beam.py) ----

    def _step_input(self, tokens, t: int):
        """Position-t decoder input [B, N, d]: the start embedding at t == 0,
        else codebooks[t-1, tokens] (tokens: [B, N] codes chosen at t-1)."""
        b, n = tokens.shape
        if t == 0:
            return self.start_embed[None, None, :].expand(b, n, -1)
        return self.codebooks[t - 1][tokens]

    def _step_logits(self, hidden, t: int):
        """Position-t logits [B, N, K] float32 from the decoder output."""
        logits = (self._maybe_scale(hidden).float()
                  @ self._out_books()[t].float().T)
        if self.cfg.apply_log_softmax:
            logits = torch.log_softmax(logits, dim=-1)
        return logits

    def decode_step_megarow(self, tokens, cache_src, cache_dst, src, kvg,
                            cross_kv: CrossKV, enc_bias, self_bias, t: int,
                            emit_quant: Optional[str] = None, ffn_q=None):
        """One beam decode step over the megarow cache
        (Decoder.decode_step_megarow). tokens: [B, N] codes chosen at step
        t-1 (ignored at t == 0). Returns (logits [B, N, K] float32 for
        position t, new cache, kv_new)."""
        hidden, new_cache, kv_new = self.decoder.decode_step_megarow(
            self._step_input(tokens, t), cache_src, cache_dst, src, kvg,
            cross_kv, enc_bias, self_bias, t, emit_quant=emit_quant,
            ffn_q=ffn_q)
        return self._step_logits(hidden, t), new_cache, kv_new

    def decode_step_deferred(self, tokens, cache_src, cache_dst, src, kvg,
                             cross_kv: CrossKV, enc_bias, self_bias, t: int,
                             write_back: bool = True, ffn_q=None):
        """One beam decode step over the layer-major merged cache with the
        reorder deferred into K4 (Decoder.decode_step_deferred). Returns
        (logits, cache_dst, kv_new [B, N, L*2F])."""
        hidden, new_cache, kv_new = self.decoder.decode_step_deferred(
            self._step_input(tokens, t), cache_src, cache_dst, src, kvg,
            cross_kv, enc_bias, self_bias, t, write_back=write_back,
            ffn_q=ffn_q)
        return self._step_logits(hidden, t), new_cache, kv_new

    def decode_step(self, tokens, cache, cross_kv: CrossKV, enc_bias,
                    self_bias, t: int):
        """One non-deferred beam decode step over the stacked cache
        (Decoder.decode_step; the cache is only read). Returns (logits,
        kv_new [L, 2, B, N, F])."""
        hidden, kv_new = self.decoder.decode_step(
            self._step_input(tokens, t), cache, cross_kv, enc_bias,
            self_bias, t)
        return self._step_logits(hidden, t), kv_new

    def decode_step_write_attend(self, tokens, cache, cross_kv: CrossKV,
                                 enc_bias, self_bias, t: int):
        """One write-then-attend beam decode step over the stacked cache
        (Decoder.decode_step_write_attend; the reference's decode_step on
        its XLA form): slot t is written in place. Returns (logits,
        cache)."""
        hidden, cache = self.decoder.decode_step_write_attend(
            self._step_input(tokens, t), cache, cross_kv, enc_bias,
            self_bias, t)
        return self._step_logits(hidden, t), cache
