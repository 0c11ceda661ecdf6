"""Cache-row codec of the quantized KV caches, the plain attention math
the step-attention kernels share, and K4 ``step_attend_reorder``.

Port of ripor_tpu/ops/attend_reorder.py. The row codec (``_quantize_rows``,
``_quantize_rows_int4``, ``_unpack_int4``, ``quantize_rows_xla[_int4]``) has
its device twin in csrc/row_codec.cuh; ``attend_plain`` is the plain
version of the attention K2, K4 and K5 share (csrc/attend_staged.cuh); and
``step_attend_reorder`` (csrc/step_attend_reorder.cu) is the deferred
decode's per-layer kernel: beam reorder of one layer of the K|V-merged
cache [L, B, N, Mc, RW] with step t-1's row inserted at slot t-1, fused
with one-position attention that reads slot t-1 from the pending rows.

Row layout. A K|V row is [2F] (K heads then V heads, D = F/H columns
each). int8 rows are [2F + SCALE_COLS]: q8 = rint(x * 2^-e) per head group
with e = ceil(log2(absmax / 127)) clipped to [-100, 100]. int4 rows are
[F + SCALE_COLS]: byte j packs (k_j + 8) | ((v_j + 8) << 4) with
e = ceil(log2(absmax / 7)) and q clipped to [-8, 7]. In both, the first 2H
tail bytes hold the exponents (K heads then V heads); the rest is zero.

2^-e is built from its exponent bits, exactly. (The reference computes it
with jnp.exp2, which XLA's CPU backend evaluates approximately outside
|e| <= 12; see ROADMAP.md Queue 3.)

The TPU kernel's knobs (``RIPOR_AR_F32_DOTS``, ``pick_chunk``, ``CHUNK``,
``WGROUP``) have no counterpart: they served the TPU's VMEM and DMA
queues.
"""
from __future__ import annotations

from typing import Optional

import torch

from ripor_tpu_torch.ops._build import (check_launch, device_kind,
                                        kernel_fn, require,
                                        require_disjoint)
from ripor_tpu_torch.ops.staging import stage_plan

SCALE_COLS = 128
_INT4_OFFSET = 8


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e as float32 for integral float e in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _exponents(xg: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-group power-of-2 exponent e = ceil(log2(absmax / qmax)),
    clipped to [-100, 100]; xg [..., G, D] float32 -> e [..., G, 1]."""
    am = xg.abs().amax(dim=-1, keepdim=True)
    e = torch.ceil(torch.log2(torch.clamp(am, min=1e-30) / qmax))
    return torch.clamp(e, -100.0, 100.0)


def _tail(e8: torch.Tensor) -> torch.Tensor:
    """[..., 2H] int8 exponents -> [..., SCALE_COLS] zero-padded tail."""
    pad = torch.zeros(*e8.shape[:-1], SCALE_COLS - e8.shape[-1],
                      dtype=torch.int8, device=e8.device)
    return torch.cat([e8, pad], dim=-1)


def quantize_rows_plain(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., 2F] float rows -> [..., 2F + SCALE_COLS] int8 cache rows."""
    G = 2 * num_heads
    lead, F2 = x.shape[:-1], x.shape[-1]
    xg = x.reshape(*lead, G, F2 // G).float()
    e = _exponents(xg, 127.0)
    q8 = torch.round(xg * pow2(-e)).to(torch.int8).reshape(*lead, F2)
    return torch.cat([q8, _tail(e[..., 0].to(torch.int8))], dim=-1)


def quantize_rows_int4_plain(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., 2F] float rows -> [..., F + SCALE_COLS] packed int4 rows."""
    H = num_heads
    lead, F2 = x.shape[:-1], x.shape[-1]
    F = F2 // 2

    def quant_half(xh):                       # [..., F] -> nibbles, e
        xg = xh.reshape(*lead, H, F // H).float()
        e = _exponents(xg, 7.0)
        q = torch.clamp(torch.round(xg * pow2(-e)), -8, 7)
        return ((q.to(torch.int32) + _INT4_OFFSET).reshape(*lead, F),
                e[..., 0].to(torch.int8))

    qk, ek = quant_half(x[..., :F])
    qv, ev = quant_half(x[..., F:])
    packed = (qk | (qv << 4)).to(torch.uint8).view(torch.int8)
    return torch.cat([packed, _tail(torch.cat([ek, ev], dim=-1))], dim=-1)


def _quantize_rows(x: torch.Tensor, num_heads: int):
    """Per-row form of the reference helper: [C, 2F] -> (q8 [C, 2F],
    epad [C, SCALE_COLS]), both int8."""
    rows = quantize_rows_plain(x, num_heads)
    return rows[..., :-SCALE_COLS], rows[..., -SCALE_COLS:]


def _quantize_rows_int4(x: torch.Tensor, num_heads: int):
    """Per-row form: [C, 2F] -> (packed [C, F], epad [C, SCALE_COLS])."""
    rows = quantize_rows_int4_plain(x, num_heads)
    return rows[..., :-SCALE_COLS], rows[..., -SCALE_COLS:]


def _unpack_int4(raw: torch.Tensor):
    """[..., F] packed int4 bytes -> (k, v) bfloat16 planes [..., F]."""
    r = raw.to(torch.int32)
    k = ((r & 15) - _INT4_OFFSET).to(torch.bfloat16)
    v = (((r >> 4) & 15) - _INT4_OFFSET).to(torch.bfloat16)
    return k, v


# cache kind codes of the kernels' C entries
KIND_CODE = {None: 0, "int8": 1, "int4": 2}


def cache_quant(cache: torch.Tensor, F: int) -> Optional[str]:
    """Quant mode of a K|V-merged cache, inferred from dtype + row width as
    the reference does: int8 rows of F + SCALE_COLS bytes are packed int4,
    other int8 rows are int8, anything else is exact."""
    if cache.dtype == torch.int8:
        return "int4" if cache.shape[-1] == F + SCALE_COLS else "int8"
    return None


def row_width(F: int, quant: Optional[str]) -> int:
    """Cache row width of a K|V row of 2F values."""
    return {None: 2 * F, "int8": 2 * F + SCALE_COLS,
            "int4": F + SCALE_COLS}[quant]


def decode_rows(rows: torch.Tensor, F: int, num_heads: int,
                quant: Optional[str]):
    """Cache rows [..., RW] -> (k, v [..., F], ek, ev [..., H] or None).
    Quantized rows give exact integer values in bf16 and their
    power-of-2 scales as float32; exact rows give views of their halves."""
    H = num_heads
    if quant is None:
        return rows[..., :F], rows[..., F:], None, None
    if quant == "int4":
        k, v = _unpack_int4(rows[..., :F])
        ef = rows[..., F:].float()
    else:
        k = rows[..., :F].to(torch.bfloat16)
        v = rows[..., F:2 * F].to(torch.bfloat16)
        ef = rows[..., 2 * F:].float()
    return k, v, pow2(ef[..., :H]), pow2(ef[..., H:2 * H])


def attend_plain(q, k_new, v_new, k_hist, v_hist, bias_hist, bias_new,
                 num_heads: int, dot_dt, ek=None, ev=None):
    """One-query attention per beam over Mc slots plus position t's own
    k/v, with the reference math's rounding points (attend_staged.cuh is
    its device twin): k·q products are formed in
    ``dot_dt`` before the f32 per-head sums; probabilities (times the V
    scale ``ev`` for quantized rows) are cast to ``dot_dt`` before they
    multiply V, and that product is formed in ``dot_dt`` too; sums and
    softmax are f32.

    q, k_new, v_new: [B, N, F]; k_hist, v_hist: [B, N, Mc, F] in
    ``dot_dt``; ek, ev: [B, N, Mc, H] float32 scales or None; bias_hist
    [Mc, H], bias_new [1, H]. Returns [B, N, F] in q's dtype."""
    B, N, F = q.shape
    H, D = num_heads, F // num_heads
    Mc = k_hist.shape[2]
    qb = q.to(dot_dt)
    kq = k_hist * qb[:, :, None, :]                       # dot-dtype products
    s_hist = kq.float().reshape(B, N, Mc, H, D).sum(-1)   # [B, N, Mc, H]
    if ek is not None:
        s_hist = s_hist * ek
    s_hist = s_hist + bias_hist.float()
    kn = k_new.to(dot_dt) * qb
    s_new = kn.float().reshape(B, N, H, D).sum(-1) + bias_new.float()
    probs = torch.softmax(torch.cat([s_hist, s_new[:, :, None]], dim=2),
                          dim=2)                          # [B, N, Mc+1, H]
    ps = probs[:, :, :Mc]
    if ev is not None:
        ps = ps * ev
    pe = ps.to(dot_dt).repeat_interleave(D, dim=-1)       # [B, N, Mc, F]
    if dot_dt == torch.float32:
        out = (pe * v_hist.float()).sum(2)
    else:
        out = (pe * v_hist).float().sum(2)
    pn = probs[:, :, Mc].to(dot_dt).float().repeat_interleave(D, dim=-1)
    return (out + pn * v_new.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# K4: step_attend_reorder
# ---------------------------------------------------------------------------

def _check_attend_reorder(q, kv_new, kvg, cache_src, cache_dst, src, layer,
                          t, bias_hist, bias_new, num_heads):
    B, N, F = q.shape
    require(cache_src.dim() == 5, f"cache_src must be [L, B, N, Mc, RW], "
                                  f"got {tuple(cache_src.shape)}")
    L, _, _, Mc, RW = cache_src.shape
    quant = cache_quant(cache_src, F)
    kvg_q8 = kvg.dtype == torch.int8
    if kvg_q8 and quant != "int8":
        raise ValueError("int8 kvg rows need an int8 cache")
    require(tuple(cache_src.shape[1:3]) == (B, N),
            f"cache {tuple(cache_src.shape)} does not match q "
            f"{tuple(q.shape)}")
    require(tuple(cache_dst.shape) == tuple(cache_src.shape)
            and cache_dst.dtype == cache_src.dtype,
            f"cache_dst {tuple(cache_dst.shape)}/{cache_dst.dtype} must "
            f"match cache_src {tuple(cache_src.shape)}/{cache_src.dtype}")
    require(F % num_heads == 0, f"F={F} not divisible by H={num_heads}")
    require(RW == row_width(F, quant),
            f"cache row width {RW} does not fit F={F} ({quant})")
    require(tuple(kv_new.shape) == (B, N, 2 * F)
            and kv_new.dtype == q.dtype,
            f"kv_new {tuple(kv_new.shape)}/{kv_new.dtype} != "
            f"{(B, N, 2 * F)}/{q.dtype}")
    kvg_rw = RW if kvg_q8 else 2 * F
    require(tuple(kvg.shape) == (B, N, L * kvg_rw),
            f"kvg {tuple(kvg.shape)} != {(B, N, L * kvg_rw)}")
    require(kvg_q8 or kvg.dtype == q.dtype,
            f"exact kvg rows must be in q's dtype {q.dtype}, got "
            f"{kvg.dtype}")
    require(quant is not None or cache_src.dtype == q.dtype,
            f"exact cache dtype {cache_src.dtype} != q dtype {q.dtype}")
    require(tuple(src.shape) == (B, N), f"src {tuple(src.shape)} != {(B, N)}")
    require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    require(0 <= t <= Mc, f"step {t} outside [0, {Mc}]")
    require(tuple(bias_hist.shape) == (Mc, num_heads),
            f"bias_hist {tuple(bias_hist.shape)} != {(Mc, num_heads)}")
    require(tuple(bias_new.shape) == (1, num_heads),
            f"bias_new {tuple(bias_new.shape)} != {(1, num_heads)}")
    return quant, kvg_q8


def step_attend_reorder_plain(q, kv_new, kvg, cache_src, cache_dst, src,
                              layer: int, t: int, bias_hist, bias_new,
                              num_heads: int, write_back: bool = True):
    """Plain version of K4; returns (attn, cache_dst), writing layer
    ``layer`` of cache_dst when ``write_back``."""
    quant, kvg_q8 = _check_attend_reorder(q, kv_new, kvg, cache_src,
                                          cache_dst, src, layer, t,
                                          bias_hist, bias_new, num_heads)
    B, N, F = q.shape
    L = cache_src.shape[0]
    H = num_heads
    rows = cache_src[layer][torch.arange(B, device=src.device)[:, None],
                            src.long()]                   # [B, N, Mc, RW]
    g = kvg.view(B, N, L, -1)[:, :, layer]                # step t-1's rows
    exact_g = quant is not None and not kvg_q8            # quantize at insert
    if t >= 1 and not exact_g:
        rows[:, :, t - 1] = g                             # verbatim insert
    if write_back:
        cache_dst[layer] = rows
        if t >= 1 and exact_g:
            quantize = (quantize_rows_int4_plain if quant == "int4"
                        else quantize_rows_plain)
            cache_dst[layer, :, :, t - 1] = quantize(g, H)
    k_hist, v_hist, ek, ev = decode_rows(rows, F, H, quant)
    if t >= 1 and exact_g:
        # the attention reads slot t-1 exactly from kvg, with scale 1
        k_hist[:, :, t - 1] = g[..., :F].to(torch.bfloat16)
        v_hist[:, :, t - 1] = g[..., F:].to(torch.bfloat16)
        ek[:, :, t - 1] = 1.0
        ev[:, :, t - 1] = 1.0
    dot_dt = torch.bfloat16 if quant else rows.dtype
    attn = attend_plain(q, kv_new[..., :F], kv_new[..., F:], k_hist, v_hist,
                        bias_hist, bias_new, H, dot_dt, ek, ev)
    return attn, cache_dst


def step_attend_reorder(q: torch.Tensor, kv_new: torch.Tensor,
                        kvg: torch.Tensor, cache_src: torch.Tensor,
                        cache_dst: torch.Tensor, src: torch.Tensor,
                        layer: int, t: int, bias_hist: torch.Tensor,
                        bias_new: torch.Tensor, num_heads: int,
                        write_back: bool = True):
    """Beam reorder of one layer of the K|V-merged cache fused with
    one-position cached self-attention (the deferred decode's step).

    q: [B, N, F]; kv_new: [B, N, 2F] position t's K|V (q's dtype);
    kvg: [B, N, L*2F] step t-1's exact K|V rows for all layers in current
    beam order (q's dtype), or, for an int8 cache only, [B, N, L*RW]
    int8 cache rows; cache_src: [L, B, N, Mc, RW] in the previous step's
    beam order (slots [0, t-1) valid); cache_dst: a distinct buffer of the
    same shape; src: [B, N] int32 current beam -> previous row, values in
    [0, N); layer, t: Python ints; bias_hist: [Mc, H] f32 (slots >= t
    masked); bias_new: [1, H] f32.

    With ``write_back`` (every step but the last), layer ``layer`` of
    cache_dst receives the reordered rows with slot t-1 := kvg's row
    (quantized here when kvg is exact and the cache is not; nothing is
    inserted at t = 0). The attention reads slot t-1 from kvg: exactly,
    with scale 1, when kvg is exact and the cache quantized, else as the
    inserted row. Returns (attn [B, N, F] in q's dtype, cache_dst)."""
    quant, kvg_q8 = _check_attend_reorder(q, kv_new, kvg, cache_src,
                                          cache_dst, src, layer, t,
                                          bias_hist, bias_new, num_heads)
    tensors = (q, kv_new, kvg, cache_src, cache_dst, src, bias_hist,
               bias_new)
    if device_kind(*tensors) == "cpu":
        return step_attend_reorder_plain(q, kv_new, kvg, cache_src,
                                         cache_dst, src, layer, t, bias_hist,
                                         bias_new, num_heads, write_back)
    B, N, F = q.shape
    L, _, _, Mc, RW = cache_src.shape
    require(q.dtype in (torch.bfloat16, torch.float32),
            f"q must be bf16 or f32, got {q.dtype}")
    require(src.dtype == torch.int32, f"src must be int32, got {src.dtype}")
    require(bias_hist.dtype == torch.float32
            and bias_new.dtype == torch.float32, "biases must be float32")
    require(all(x.is_contiguous() for x in tensors),
            "step_attend_reorder needs contiguous tensors")
    require_disjoint(cache_src, cache_dst, "cache_dst")
    plan = stage_plan(quant, cache_src.element_size(), q.element_size(), Mc,
                      F, num_heads, exact_kvg=quant is not None and not kvg_q8)
    attn = torch.empty_like(q)
    fn = kernel_fn("step_attend_reorder", "step_attend_reorder", 9, 16)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), kv_new.data_ptr(), kvg.data_ptr(),
                cache_src.data_ptr(), cache_dst.data_ptr(), src.data_ptr(),
                bias_hist.data_ptr(), bias_new.data_ptr(), attn.data_ptr(),
                B, N, L, Mc, F, num_heads, RW, layer, t, int(write_back),
                KIND_CODE[quant], int(kvg_q8), int(q.dtype == torch.float32),
                plan.chunk_slots, plan.stages, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "step_attend_reorder")
    return attn, cache_dst
