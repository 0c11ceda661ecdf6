"""Megarow decode ops: all-layers beam reorder + per-layer step attention.

Port of ripor_tpu/ops/megarow.py. The cache is beam-major,
[B, N, L, Mc, RW]: one beam's rows for all L layers are contiguous, so the
per-step reorder moves one slab per beam.

  K1 ``reorder_cache_all`` (once per step, csrc/reorder_cache_all.cu):
  cache_dst[b, n] = cache_src[b, src[b, n]] over all layers, with slot
  max(t-1, 0) of every layer replaced by that layer's row of ``kvg``
  (step t-1's K|V). The insert is inferred from the dtypes and the row
  width, as the reference infers it: cache-layout rows (QFUSE int8 rows,
  or exact rows into an exact cache) go in verbatim; exact rows into an
  int8 cache are quantized to int8 or int4 on insert (K1', the
  reference's QFUSE-off body). ``fused_kvg`` takes kvg un-permuted and
  gathers row src[b, n] itself (K1'', the reference's FUSED_KVG body), so
  the decode skips K3.

  K2 ``step_attention_seq`` (once per layer, csrc/step_attention_seq.cu):
  one-query attention per beam over slots [0, t) of layer l of the
  reordered cache, with position t's own k/v folded into the softmax.
  int8/int4 rows are dequantized by per-(slot, head) power-of-2 exponents.
  With ``emit_quant`` it also returns kv_new quantized to cache rows (the
  rows the next step's K1 inserts). ``mxu_math`` (K2', the reference's
  RIPOR_MR_MXU math) keeps the bf16 rounding of each k*q product on
  int8/int4 rows but forms the p*v products exactly in f32. Each beam's
  layer slab is staged in shared memory; ops/staging.py plans the stages.

The TPU kernels' tuning knobs (chunk, layer group, descriptor width, VMEM
budgets, beam padding) have no counterpart here: they served the TPU's
VMEM and DMA engines.
"""
from __future__ import annotations

from typing import Optional

import torch

from ripor_tpu_torch.ops._build import (check_launch, device_kind,
                                        kernel_fn, require,
                                        require_disjoint)
from ripor_tpu_torch.ops.attend_reorder import (
    KIND_CODE, SCALE_COLS, attend_plain, cache_quant, decode_rows,
    quantize_rows_int4_plain, quantize_rows_plain, row_width)
from ripor_tpu_torch.ops.staging import stage_plan


# ---------------------------------------------------------------------------
# K1: reorder_cache_all
# ---------------------------------------------------------------------------

def _check_reorder(kvg, cache_src, cache_dst, src, num_heads):
    """The insert's quantization (None, "int8", "int4"; None is verbatim),
    inferred as the reference infers it (megarow.py:309-318)."""
    B, N, L, Mc, RW = cache_src.shape
    require(tuple(cache_dst.shape) == tuple(cache_src.shape)
            and cache_dst.dtype == cache_src.dtype,
            f"cache_dst {tuple(cache_dst.shape)}/{cache_dst.dtype} must "
            f"match cache_src {tuple(cache_src.shape)}/{cache_src.dtype}")
    require(tuple(src.shape) == (B, N), f"src {tuple(src.shape)} != {(B, N)}")
    require(kvg.dim() == 3 and tuple(kvg.shape[:2]) == (B, N)
            and kvg.shape[2] % L == 0,
            f"kvg {tuple(kvg.shape)} is not [{B}, {N}, L*row] with L={L}")
    krow = kvg.shape[2] // L
    if kvg.dtype == cache_src.dtype:
        require(krow == RW, f"kvg rows of {krow} != cache rows of {RW}")
        return None
    require(cache_src.dtype == torch.int8
            and kvg.dtype in (torch.bfloat16, torch.float32),
            f"kvg dtype {kvg.dtype} cannot go into a {cache_src.dtype} "
            f"cache: int8 rows need a quantized cache, exact rows an exact "
            f"cache of their dtype or an int8 one")
    quant = "int4" if RW == krow // 2 + SCALE_COLS else "int8"
    require(krow % 2 == 0 and RW == row_width(krow // 2, quant),
            f"cache rows of {RW} bytes fit no quantization of {krow}-wide "
            f"kvg rows")
    if num_heads is None:
        raise ValueError("quantize-on-insert (exact kvg rows into an int8 "
                         "cache) needs num_heads")
    require((krow // 2) % num_heads == 0,
            f"F={krow // 2} not divisible by H={num_heads}")
    return quant


def reorder_cache_all_plain(kvg, cache_src, cache_dst, src, t: int,
                            num_heads: Optional[int] = None,
                            fused_kvg: bool = False):
    """Plain version of K1 (and K1', K1''); writes cache_dst and returns
    it."""
    quant = _check_reorder(kvg, cache_src, cache_dst, src, num_heads)
    B, N, L, Mc, RW = cache_src.shape
    bidx = torch.arange(B, device=src.device)[:, None]
    cache_dst.copy_(cache_src[bidx, src.long()])
    rows = (kvg[bidx, src.long()] if fused_kvg else kvg).reshape(B, N, L, -1)
    if quant == "int4":
        rows = quantize_rows_int4_plain(rows, num_heads)
    elif quant == "int8":
        rows = quantize_rows_plain(rows, num_heads)
    cache_dst[:, :, :, max(t - 1, 0)] = rows
    return cache_dst


def reorder_body(quantize: bool, fused_kvg: bool) -> str:
    """The launch counter of K1's body: K1'' (fused), K1' (quantize on
    insert) or K1 (verbatim)."""
    if fused_kvg:
        return "reorder_cache_all_fused"
    return "reorder_cache_all_qinsert" if quantize else "reorder_cache_all"


def reorder_cache_all(kvg: torch.Tensor, cache_src: torch.Tensor,
                      cache_dst: torch.Tensor, src: torch.Tensor,
                      t: int, num_heads: Optional[int] = None,
                      fused_kvg: bool = False) -> torch.Tensor:
    """Beam-reorder the whole megarow cache (all layers) in one pass.

    kvg: [B, N, L*w] step t-1's rows, layer-major: cache-layout rows (w =
    RW, the cache's dtype: QFUSE int8 rows, or exact rows of an exact
    cache), inserted verbatim; or exact bf16/f32 K|V rows (w = 2F) into an
    int8 cache, quantized on insert to int4 where RW == F + SCALE_COLS and
    to int8 otherwise (``num_heads`` is then required). With
    ``fused_kvg`` False the rows are in current beam order; with True
    they are un-permuted and row src[b, n] goes to beam n.
    cache_src: [B, N, L, Mc, RW]; cache_dst: a distinct buffer of the
    same shape (written, returned); src: [B, N] int32 current beam ->
    previous row, values in [0, N); t: the step (a Python int). Slot
    max(t-1, 0) of every layer of cache_dst receives the inserted row."""
    quant = _check_reorder(kvg, cache_src, cache_dst, src, num_heads)
    if device_kind(kvg, cache_src, cache_dst, src) == "cpu":
        return reorder_cache_all_plain(kvg, cache_src, cache_dst, src, t,
                                       num_heads, fused_kvg)
    B, N, L, Mc, RW = cache_src.shape
    require(src.dtype == torch.int32, f"src must be int32, got {src.dtype}")
    require(all(x.is_contiguous() for x in (kvg, cache_src, cache_dst, src)),
            "reorder_cache_all needs contiguous tensors")
    require_disjoint(cache_src, cache_dst, "cache_dst")
    fn = kernel_fn("reorder_cache_all", "reorder_cache_all", 4, 11)
    with torch.cuda.device(cache_src.device):
        rc = fn(kvg.data_ptr(), cache_src.data_ptr(), cache_dst.data_ptr(),
                src.data_ptr(), B, N, L, Mc,
                RW * cache_src.element_size(), max(t - 1, 0),
                KIND_CODE[quant], int(kvg.dtype == torch.float32),
                int(fused_kvg), kvg.shape[2] // L // 2, num_heads or 0,
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, reorder_body(quant is not None, fused_kvg))
    return cache_dst


# ---------------------------------------------------------------------------
# K2: step_attention_seq
# ---------------------------------------------------------------------------

def _check_seq(q, kv_new, cache, layer, bias_hist, bias_new, num_heads,
               emit_quant):
    B, N, F = q.shape
    _, _, L, Mc, RW = cache.shape
    quant = cache_quant(cache, F)
    if emit_quant is not None and emit_quant != quant:
        raise ValueError(
            f"emit_quant={emit_quant!r} must match the cache quantization "
            f"({quant!r}) — the emitted rows are next step's verbatim "
            f"cache inserts")
    require(tuple(cache.shape[:2]) == (B, N),
            f"cache {tuple(cache.shape)} does not match q {tuple(q.shape)}")
    require(tuple(kv_new.shape) == (B, N, 2 * F),
            f"kv_new {tuple(kv_new.shape)} != {(B, N, 2 * F)}")
    require(F % num_heads == 0, f"F={F} not divisible by H={num_heads}")
    require(RW == row_width(F, quant),
            f"cache row width {RW} does not fit F={F} ({quant})")
    require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    require(tuple(bias_hist.shape) == (Mc, num_heads),
            f"bias_hist {tuple(bias_hist.shape)} != {(Mc, num_heads)}")
    require(tuple(bias_new.shape) == (1, num_heads),
            f"bias_new {tuple(bias_new.shape)} != {(1, num_heads)}")
    return quant


def step_attention_seq_plain(q, kv_new, cache, layer: int, bias_hist,
                             bias_new, num_heads: int,
                             emit_quant: Optional[str] = None,
                             mxu_math: bool = False):
    """Plain version of K2: attend_plain over layer ``layer``'s rows (the
    reference math _seq_math / _seq_math_quant): the dot dtype is bf16 for
    quantized caches, else the cache dtype. With ``mxu_math`` on a
    quantized cache, K2' (_seq_math_quant_mxu): the p*v products are
    exact f32 products of the bf16 probabilities and the integer values;
    on an exact cache ``mxu_math`` changes nothing, as in the reference."""
    quant = _check_seq(q, kv_new, cache, layer, bias_hist, bias_new,
                       num_heads, emit_quant)
    F = q.shape[2]
    rows = cache[:, :, layer]                             # [B, N, Mc, RW]
    k_hist, v_hist, ek, ev = decode_rows(rows, F, num_heads, quant)
    dot_dt = torch.bfloat16 if quant else rows.dtype
    attn = attend_plain(q, kv_new[..., :F], kv_new[..., F:], k_hist, v_hist,
                        bias_hist, bias_new, num_heads, dot_dt, ek, ev,
                        exact_pv=mxu_math and quant is not None)
    if emit_quant == "int4":
        return attn, quantize_rows_int4_plain(kv_new, num_heads)
    if emit_quant == "int8":
        return attn, quantize_rows_plain(kv_new, num_heads)
    return attn


def step_attention_seq(q: torch.Tensor, kv_new: torch.Tensor,
                       cache: torch.Tensor, layer: int,
                       bias_hist: torch.Tensor, bias_new: torch.Tensor,
                       num_heads: int, emit_quant: Optional[str] = None,
                       mxu_math: bool = False):
    """One-position cached self-attention over the reordered megarow cache.

    q: [B, N, F]; kv_new: [B, N, 2F] position t's K|V (q's dtype);
    cache: [B, N, L, Mc, RW], slots [0, t) valid and in current beam
    order; layer: Python int; bias_hist: [Mc, H] f32 (slots >= t masked);
    bias_new: [1, H] f32. Returns attn [B, N, F] in q's dtype, and with
    ``emit_quant`` ("int8"/"int4", must match the cache) also kvq
    [B, N, RW] int8: kv_new in cache-row layout. ``mxu_math``: K2' on an
    int8/int4 cache (exact p*v products, step_attention_seq_plain); no
    effect on an exact cache."""
    quant = _check_seq(q, kv_new, cache, layer, bias_hist, bias_new,
                       num_heads, emit_quant)
    mxu = bool(mxu_math) and quant is not None
    if device_kind(q, kv_new, cache, bias_hist, bias_new) == "cpu":
        return step_attention_seq_plain(q, kv_new, cache, layer, bias_hist,
                                        bias_new, num_heads, emit_quant, mxu)
    B, N, F = q.shape
    _, _, L, Mc, RW = cache.shape
    require(q.dtype in (torch.bfloat16, torch.float32)
            and kv_new.dtype == q.dtype,
            f"q/kv_new must share dtype bf16 or f32, got {q.dtype}/"
            f"{kv_new.dtype}")
    require(quant is not None or cache.dtype == q.dtype,
            f"exact cache dtype {cache.dtype} != q dtype {q.dtype}")
    require(bias_hist.dtype == torch.float32
            and bias_new.dtype == torch.float32, "biases must be float32")
    require(all(x.is_contiguous() for x in
                (q, kv_new, cache, bias_hist, bias_new)),
            "step_attention_seq needs contiguous tensors")
    plan = stage_plan(quant, cache.element_size(), q.element_size(), Mc, F,
                      num_heads)
    attn = torch.empty_like(q)
    kvq = (torch.empty(B, N, RW, dtype=torch.int8, device=q.device)
           if emit_quant else None)
    fn = kernel_fn("step_attention_seq", "step_attention_seq", 7, 14)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), kv_new.data_ptr(), cache.data_ptr(),
                bias_hist.data_ptr(), bias_new.data_ptr(), attn.data_ptr(),
                kvq.data_ptr() if kvq is not None else None,
                B * N, L, Mc, F, num_heads, RW, layer, KIND_CODE[quant],
                int(q.dtype == torch.float32), int(kvq is not None),
                plan.chunk_slots, plan.stages, plan.smem_bytes, int(mxu),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "step_attention_seq_mxu" if mxu
                 else "step_attention_seq")
    return (attn, kvq) if emit_quant else attn
