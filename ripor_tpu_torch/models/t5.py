"""T5 encoder / decoder stacks in PyTorch, with the beam decode steps.

Port of ripor_tpu/models/t5.py: the full-sequence encoder and decoder, and
the decoder's four beam decode steps:
  megarow            [B, N, L, Mc, RW]    K1 + K2 (ops/megarow.py)
  deferred           [L, B, N, Mc, RW]    K4 (ops/attend_reorder.py)
  non-deferred       [L, 2, B, N, Mc, F]  K5 (ops/step_attention.py); the
                                          beam loop's reorder inserts the
                                          new k/v
  write-then-attend  [L, 2, B, N, Mc, F]  the new k/v written at slot t,
                                          then K8 (ops/step_attention.py)
Beams are a first-class axis and cross-attention reads the unexpanded
encoder K/V [B, S, H, D].

The full-sequence forwards train: with ``deterministic=False`` they apply
dropout where the flax modules do, and ``T5Config.remat_layers``
recomputes each layer in the backward pass (``torch.utils.checkpoint``).
The stack draws one seed a layer from the caller's ``generator`` before
the layer runs, and the layer draws its masks from a fresh generator
seeded with it, so a recomputed layer replays its masks exactly
(checkpoint's own RNG stashing covers only the global generators).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ripor_tpu_torch.models.config import T5Config
from ripor_tpu_torch.models.layers import (
    NEG_INF,
    Attention,
    FeedForward,
    RelativePositionBias,
    RMSNorm,
    causal_bias,
    dropout,
    padding_bias,
)
from ripor_tpu_torch.ops.attend_reorder import (row_width,
                                                 step_attend_reorder)
from ripor_tpu_torch.ops.int8_ffn import ffn_int8_apply
from ripor_tpu_torch.ops.megarow import reorder_cache_all, step_attention_seq
from ripor_tpu_torch.ops.step_attention import (step_attention,
                                                 step_attention_fused)

CrossKV = List[Tuple[torch.Tensor, torch.Tensor]]


def _dropout_seeds(n: int, rate: float, deterministic: bool,
                   generator: Optional[torch.Generator]) -> List:
    """n dropout seeds drawn from ``generator`` (any device), or n Nones
    where no dropout applies."""
    if deterministic or rate == 0.0:
        return [None] * n
    if generator is None:
        raise ValueError("deterministic=False needs a dropout generator")
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


def _seeded(seed: Optional[int], device) -> Optional[torch.Generator]:
    return (None if seed is None
            else torch.Generator(device=device).manual_seed(seed))


def _seeded_dropout(x, rate: float, seed: Optional[int]):
    return dropout(x, rate, seed is None, _seeded(seed, x.device))


def _run_layer(layer, remat: bool, seed: Optional[int], x, *args):
    """layer(x, *args) with its dropout masks drawn from a generator seeded
    with ``seed`` (None: deterministic); with ``remat`` the layer's
    activations are recomputed in the backward pass, the same masks
    included."""
    def run(x, *args):
        return layer(x, *args, deterministic=seed is None,
                     generator=_seeded(seed, x.device))
    if remat and torch.is_grad_enabled():
        return checkpoint(run, x, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run(x, *args)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        eps = cfg.layer_norm_epsilon
        self.attn_norm = RMSNorm(cfg.d_model, eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.ffn_norm = RMSNorm(cfg.d_model, eps, **kw)
        self.ffn = FeedForward(cfg, **kw)
        self.rate = cfg.dropout_rate

    def forward(self, x, bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        def drop(h):
            return dropout(h, self.rate, deterministic, generator)
        x = x + drop(self.attn(self.attn_norm(x), bias=bias))
        return x + drop(self.ffn(self.ffn_norm(x), deterministic, generator))


class Encoder(nn.Module):
    """T5 encoder over already-embedded inputs."""

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.rel_bias = RelativePositionBias(cfg, bidirectional=True, **kw)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)
        self.cfg = cfg

    def forward(self, embeds, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        L = embeds.shape[1]
        bias = self.rel_bias(L, L) + padding_bias(mask)
        seeds = _dropout_seeds(len(self.layers) + 2, cfg.dropout_rate,
                               deterministic, generator)
        x = _seeded_dropout(embeds, cfg.dropout_rate, seeds[0])
        for layer, seed in zip(self.layers, seeds[1:]):
            x = _run_layer(layer, cfg.remat_layers, seed, x, bias)
        return _seeded_dropout(self.final_norm(x), cfg.dropout_rate,
                               seeds[-1])


def _step_cross_attention(q, enc_k, enc_v, enc_bias, dtype):
    """Beam-shared cross-attention: q [B, N, H, D] x enc [B, S, H, D];
    enc_bias [B, S] additive. The encoder K/V are broadcast over beams,
    never expanded per beam."""
    scores = torch.einsum("bnhd,bshd->bnhs", q.float(), enc_k.float())
    scores = scores + enc_bias[:, None, None, :].float()
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bnhs,bshd->bnhd", probs, enc_v)


def _layer_ffn_q(ffn_q, l: int):
    return None if ffn_q is None else tuple(a[l] for a in ffn_q)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        eps = cfg.layer_norm_epsilon
        self.self_attn_norm = RMSNorm(cfg.d_model, eps, **kw)
        self.self_attn = Attention(cfg, **kw)
        self.cross_attn_norm = RMSNorm(cfg.d_model, eps, **kw)
        self.cross_attn = Attention(cfg, **kw)
        self.ffn_norm = RMSNorm(cfg.d_model, eps, **kw)
        self.ffn = FeedForward(cfg, **kw)

    def forward(self, x, enc, self_bias, cross_bias,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        def drop(h):
            return dropout(h, self.cfg.dropout_rate, deterministic, generator)
        x = x + drop(self.self_attn(self.self_attn_norm(x), bias=self_bias))
        x = x + drop(self.cross_attn(self.cross_attn_norm(x), kv_input=enc,
                                     bias=cross_bias))
        return x + drop(self.ffn(self.ffn_norm(x), deterministic, generator))

    def cross_kv(self, enc):
        """Cross-attention K/V from the encoder output (once per query)."""
        return self.cross_attn.project_kv(enc)

    def step_qkv(self, x):
        """Self-attention projections for one decode position, flat:
        x [B, N, d] -> q, k, v [B, N, F]."""
        h = self.self_attn_norm(x)
        sa = self.self_attn
        return sa.q(h), sa.k(h), sa.v(h)

    def step_finish_with_attn(self, x, attn_flat, enc_k, enc_v, enc_bias,
                              ffn_q=None):
        """Residual + output projection of the self-attention result
        [B, N, inner], then cross-attention and FFN. ``ffn_q``: optional
        (wi_q, wi_s, wo_q, wo_s) int8 FFN weights of this layer
        (ops/int8_ffn.py), which replace the FFN's matmuls."""
        x = x + self.self_attn.out_flat(attn_flat)
        cq = self.cross_attn.project_q(self.cross_attn_norm(x))
        attn = _step_cross_attention(cq, enc_k, enc_v, enc_bias, self.dtype)
        x = x + self.cross_attn.out(attn)
        if ffn_q is not None:
            return x + ffn_int8_apply(self.ffn_norm(x), *ffn_q,
                                      tp_group=self.ffn.tp_group)
        return x + self.ffn(self.ffn_norm(x))


class Decoder(nn.Module):
    """T5 decoder over already-embedded inputs, full-sequence and beam
    step paths (keeps the final layer norm, as the reference does)."""

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.rel_bias = RelativePositionBias(cfg, bidirectional=False, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_decoder_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)

    def forward(self, embeds, enc, enc_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        L = embeds.shape[1]
        self_bias = self.rel_bias(L, L) + causal_bias(L, embeds.device)
        cross_bias = padding_bias(enc_mask)
        seeds = _dropout_seeds(len(self.layers) + 2, cfg.dropout_rate,
                               deterministic, generator)
        x = _seeded_dropout(embeds, cfg.dropout_rate, seeds[0])
        for layer, seed in zip(self.layers, seeds[1:]):
            x = _run_layer(layer, cfg.remat_layers, seed, x, enc, self_bias,
                           cross_bias)
        return _seeded_dropout(self.final_norm(x), cfg.dropout_rate,
                               seeds[-1])

    # ---- decode path ----

    def full_self_bias(self, max_len: int) -> torch.Tensor:
        """[H, M, M] float32 relpos + causal bias, computed once per call."""
        bias = self.rel_bias(max_len, max_len)[0]
        return bias + causal_bias(max_len, self._device())[0, 0]

    def precompute_cross_kv(self, enc) -> CrossKV:
        return [layer.cross_kv(enc) for layer in self.layers]

    def _cache_rows(self, quantized) -> Tuple[int, torch.dtype]:
        """(row width, dtype) of K|V-merged cache rows: exact [2F] rows in
        the compute dtype; "int8"/True int8 rows [2F + SCALE_COLS]; "int4"
        packed rows [F + SCALE_COLS]."""
        quant = ("int8" if quantized is True else quantized) or None
        return (row_width(self.cfg.inner_dim, quant),
                torch.int8 if quant else self.dtype)

    def init_cache_megarow(self, batch: int, num_beams: int, max_len: int,
                           quantized: "bool | str" = False) -> torch.Tensor:
        """Zeroed beam-major K|V-merged cache [B, N, L, Mc, RW] (rows as in
        _cache_rows).

        Zeroed, not empty: masked slots are multiplied by probability 0,
        and 0 * NaN (a bf16 garbage pattern) or an int8 garbage exponent
        (2^127) would poison the sum. The same holds for every cache
        below."""
        rw, dt = self._cache_rows(quantized)
        return torch.zeros(batch, num_beams, self.cfg.num_decoder_layers,
                           max_len, rw, dtype=dt, device=self._device())

    def init_cache_merged(self, batch: int, num_beams: int, max_len: int,
                          quantized: "bool | str" = False) -> torch.Tensor:
        """Zeroed layer-major K|V-merged cache [L, B, N, Mc, RW] of the
        deferred decode (rows as in _cache_rows)."""
        rw, dt = self._cache_rows(quantized)
        return torch.zeros(self.cfg.num_decoder_layers, batch, num_beams,
                           max_len, rw, dtype=dt, device=self._device())

    def init_cache(self, batch: int, num_beams: int,
                   max_len: int) -> torch.Tensor:
        """Zeroed stacked cache [L, 2, B, N, Mc, F] (K plane, V plane) of the
        non-deferred decode, in the compute dtype."""
        cfg = self.cfg
        return torch.zeros(cfg.num_decoder_layers, 2, batch, num_beams,
                           max_len, cfg.inner_dim, dtype=self.dtype,
                           device=self._device())

    def _device(self):
        return self.rel_bias.rel_embedding.device

    @staticmethod
    def _step_biases(self_bias_full, t: int, cache_len: int):
        """Position t's self-attention biases over a cache of cache_len
        slots: bias_hist [Mc, H] (relpos, slots >= t masked: history holds
        [0, t), position t enters on its own) and bias_new [1, H]."""
        bias_row = self_bias_full[:, t, :cache_len]             # [H, Mc]
        key_pos = torch.arange(cache_len, device=bias_row.device)
        bias_hist = (bias_row + torch.where(key_pos < t, 0.0, NEG_INF)
                     [None, :]).T.contiguous()                 # [Mc, H]
        bias_new = bias_row[:, t][None, :].contiguous()         # [1, H]
        return bias_hist, bias_new

    def step_bias_tables(self, self_bias_full):
        """_step_biases of every position at once: (hist [M, M, H], new
        [M, 1, H]) with _step_biases(self_bias_full, t, Mc) equal to
        (hist[t, :Mc], new[t]), both contiguous."""
        M = self_bias_full.shape[1]
        key_pos = torch.arange(M, device=self_bias_full.device)
        masked = torch.where(key_pos[None, :] < key_pos[:, None], 0.0,
                             NEG_INF)                           # [M, M]
        hist = (self_bias_full + masked[None]).permute(1, 2, 0).contiguous()
        new = torch.diagonal(self_bias_full, dim1=1, dim2=2).T.contiguous()
        return hist, new[:, None, :]

    # The megarow decode step, in the pieces the beam search calls one by
    # one (decode/beam.py, which replays the plain-torch ones as CUDA
    # graphs): K1, then for each layer its projections, K2 and the rest of
    # the layer; the last layer's output goes through final_norm. K1 and
    # K2 launch through this module's names, which portbench/profiling.py
    # wraps to count their calls.

    def megarow_reorder(self, kvg, cache_src, cache_dst, src, t: int,
                        fused_kvg: bool = False):
        """K1: completes the pending beam reorder and the slot t-1 insert
        from ``cache_src`` into ``cache_dst`` (returned).

        src: [B, N] int32 current beam -> previous row; kvg: [B, N, L*w]
        step t-1's rows of every layer: cache-layout rows, or exact [2F]
        rows that K1 quantizes on insert into a quantized cache (K1'); in
        current beam order, or un-permuted with ``fused_kvg`` (K1'' gathers
        them by src); t: Python int."""
        return reorder_cache_all(kvg, cache_src, cache_dst, src, t,
                                 self.cfg.num_heads, fused_kvg=fused_kvg)

    def megarow_qkv(self, l: int, x, out=None):
        """Layer l's projections of position t from x [B, N, d]: q
        [B, N, F] and its K|V row kvf [B, N, 2F] (written into ``out`` if
        given)."""
        q, k, v = self.layers[l].step_qkv(x)
        return q, torch.cat([k, v], dim=-1, out=out)

    def megarow_attend(self, q, kvf, cache, l: int, bias_hist, bias_new,
                       emit_quant: Optional[str] = None,
                       mxu_math: bool = False, out=None):
        """K2 over layer l of the reordered cache: attn, or with
        ``emit_quant`` (attn, kvq), kvq being kvf in cache-row layout
        (QFUSE). ``mxu_math``: K2' on a quantized cache. ``out`` as
        ops/megarow.py::step_attention_seq's. The biases are
        step_bias_tables' rows of position t."""
        return step_attention_seq(q, kvf, cache, l, bias_hist, bias_new,
                                  self.cfg.num_heads, emit_quant=emit_quant,
                                  mxu_math=mxu_math, out=out)

    def megarow_finish(self, l: int, x, attn, cross_kv: CrossKV, enc_bias,
                       ffn_q=None):
        """Layer l after its self-attention: output projection,
        cross-attention and FFN. ``ffn_q``: optional stacked int8 FFN
        weights (ops/int8_ffn.py quantize_ffn), layer l taking index l of
        each."""
        enc_k, enc_v = cross_kv[l]
        return self.layers[l].step_finish_with_attn(
            x, attn, enc_k, enc_v, enc_bias, _layer_ffn_q(ffn_q, l))

    def decode_step_deferred(self, x, cache_src, cache_dst, src, kvg,
                             cross_kv: CrossKV, enc_bias, self_bias_full,
                             t: int, write_back: bool = True, ffn_q=None):
        """One decode step with the beam reorder deferred one step and
        fused, layer by layer, into K4: rows of ``cache_src`` are read
        through ``src``, slot t-1 is completed from ``kvg`` and, with
        ``write_back`` (every step but the last), the ordered rows land in
        ``cache_dst``.

        x: [B, N, d]; cache_src/cache_dst: [L, B, N, Mc, RW] pair
        (init_cache_merged); src: [B, N] int32; kvg: [B, N, L*2F] step
        t-1's exact K|V rows in current beam order (or, for an int8 cache,
        [B, N, L*RW] int8 rows); ``ffn_q`` as in megarow_finish.
        Returns (hidden, cache_dst, kv_new [B, N, L*2F])."""
        bias_hist, bias_new = self._step_biases(self_bias_full, t,
                                                cache_src.shape[3])
        kvnews = []
        for l, (layer, (enc_k, enc_v)) in enumerate(zip(self.layers,
                                                         cross_kv)):
            q, k, v = layer.step_qkv(x)
            kvf = torch.cat([k, v], dim=-1)
            attn, _ = step_attend_reorder(q, kvf, kvg, cache_src, cache_dst,
                                          src, l, t, bias_hist, bias_new,
                                          self.cfg.num_heads,
                                          write_back=write_back)
            kvnews.append(kvf)
            x = layer.step_finish_with_attn(x, attn, enc_k, enc_v, enc_bias,
                                            _layer_ffn_q(ffn_q, l))
        kv_new = torch.stack(kvnews, dim=2).reshape(x.shape[0], x.shape[1],
                                                    -1)
        return self.final_norm(x), cache_dst, kv_new

    def decode_step(self, x, cache, cross_kv: CrossKV, enc_bias,
                    self_bias_full, t: int):
        """One non-deferred decode step: each layer runs K5 over the
        stacked cache [L, 2, B, N, Mc, F] (history in slots [0, t)) with
        position t's k/v folded in. The cache is only read; the beam loop's
        reorder (K6) writes this step's rows into slot t.

        Returns (hidden [B, N, d], kv_new [L, 2, B, N, F])."""
        bias_hist, bias_new = self._step_biases(self_bias_full, t,
                                                cache.shape[4])
        ks, vs = [], []
        for l, (layer, (enc_k, enc_v)) in enumerate(zip(self.layers,
                                                         cross_kv)):
            q, k, v = layer.step_qkv(x)
            attn = step_attention_fused(q, k, v, cache, l, bias_hist,
                                        bias_new, self.cfg.num_heads)
            ks.append(k)
            vs.append(v)
            x = layer.step_finish_with_attn(x, attn, enc_k, enc_v, enc_bias)
        return self.final_norm(x), torch.stack([torch.stack(ks),
                                                torch.stack(vs)], dim=1)

    def decode_step_write_attend(self, x, cache, cross_kv: CrossKV, enc_bias,
                                 self_bias_full, t: int):
        """One write-then-attend decode step, the reference's
        Decoder.decode_step on its XLA form (step_attn_impl="xla"): each
        layer writes position t's k and v in place into slot t of the
        stacked cache [L, 2, B, N, Mc, F], then runs K8 over the layer's K
        and V planes with slots [0, t] visible.

        Returns (hidden [B, N, d], cache) — the same cache, written."""
        cache_len = cache.shape[4]
        bias_row = self_bias_full[:, t, :cache_len]             # [H, Mc]
        key_pos = torch.arange(cache_len, device=bias_row.device)
        bias = (bias_row + torch.where(key_pos <= t, 0.0, NEG_INF)
                [None, :]).T.contiguous()                      # [Mc, H]
        for l, (layer, (enc_k, enc_v)) in enumerate(zip(self.layers,
                                                         cross_kv)):
            q, k, v = layer.step_qkv(x)
            cache[l, 0, :, :, t] = k
            cache[l, 1, :, :, t] = v
            attn = step_attention(q, cache[l, 0], cache[l, 1], bias,
                                  self.cfg.num_heads)
            x = layer.step_finish_with_attn(x, attn, enc_k, enc_v, enc_bias)
        return self.final_norm(x), cache
