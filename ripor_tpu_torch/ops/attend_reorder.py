"""Cache-row codec of the quantized KV caches (plain PyTorch).

Port of the row codec in ripor_tpu/ops/attend_reorder.py (``_quantize_rows``,
``_quantize_rows_int4``, ``_unpack_int4``, ``quantize_rows_xla[_int4]``).
Its device twin is csrc/row_codec.cuh, which step_attention_seq's kernel
runs to emit quantized rows (QFUSE); the functions here are that code's
plain version and the CPU path.

Row layout. A K|V row is [2F] (K heads then V heads, D = F/H columns
each). int8 rows are [2F + SCALE_COLS]: q8 = rint(x * 2^-e) per head group
with e = ceil(log2(absmax / 127)) clipped to [-100, 100]. int4 rows are
[F + SCALE_COLS]: byte j packs (k_j + 8) | ((v_j + 8) << 4) with
e = ceil(log2(absmax / 7)) and q clipped to [-8, 7]. In both, the first 2H
tail bytes hold the exponents (K heads then V heads); the rest is zero.

2^-e is built from its exponent bits, exactly. (The reference computes it
with jnp.exp2, which XLA's CPU backend evaluates approximately outside
|e| <= 12; see ROADMAP.md Queue 3.)
"""
from __future__ import annotations

import torch

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
