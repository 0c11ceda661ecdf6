"""int8-weight FFN for the decode step (``ffn_int8=True``).

Port of ripor_tpu/ops/int8_ffn.py, which the JAX package computes with
plain XLA ops (no Pallas kernel): per-output-channel symmetric int8
weights, quantized once per search, and per-row dynamic symmetric int8
activations, with exact int32 accumulation of the int8 products. The
relu output entering ``wo`` is non-negative, so its int8 row uses only
the 0..127 half-range.

The int8 products are ``torch._int_mm`` (int8 x int8 -> int32, exact on
the CPU and on the card, where it runs on the int8 tensor cores). Only
the non-gated T5 v1.0 FFN (wi/wo) is supported; gated variants keep the
bf16 path. The JAX package's ``tp_axis`` (row-parallel wo partials summed
across a mesh) waits for the tensor-parallel slice.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as Fn

FfnQ = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# torch._int_mm on the card needs more than 16 rows
_MIN_ROWS = 17


def _quantize_out_channels(w: torch.Tensor):
    """w [L, out, in] -> (q [L, in, out] int8, s [L, 1, out] f32) with
    w ~= q * s per output channel; q is a transposed view of a contiguous
    [L, out, in] tensor (the column-major operand the int8 product takes)."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=2, keepdim=True) / 127.0, 1e-12)
    q = torch.round(w / s).to(torch.int8)
    return q.transpose(1, 2), s.transpose(1, 2)


def quantize_ffn(params: Mapping[str, torch.Tensor], n_layers: int) -> FfnQ:
    """Quantize the decoder FFN weights to per-output-channel int8.

    params: a RiporModel state_dict. Returns stacked (wi_q [L, d, f] int8,
    wi_s [L, 1, f] f32, wo_q [L, f, d] int8, wo_s [L, 1, d] f32), the
    layouts of the JAX package's quantize_ffn, such that wi ~= wi_q * wi_s.
    """
    wis, wos = [], []
    for l in range(n_layers):
        pre = f"decoder.layers.{l}.ffn."
        if pre + "wi.weight" not in params:
            raise ValueError("int8 FFN supports only the non-gated T5 v1.0 "
                             "FFN (wi/wo); got a gated variant")
        wis.append(params[pre + "wi.weight"])        # [f, d] (out, in)
        wos.append(params[pre + "wo.weight"])        # [d, f]
    wi_q, wi_s = _quantize_out_channels(torch.stack(wis))
    wo_q, wo_s = _quantize_out_channels(torch.stack(wos))
    return wi_q, wi_s, wo_q, wo_s


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 a [m, k] and int8 b [k, n]."""
    m = a.shape[0]
    if a.is_cuda and m < _MIN_ROWS:
        a = Fn.pad(a, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(a, b)[:m]


def _quantize_rows(x: torch.Tensor, scale_max: torch.Tensor) -> torch.Tensor:
    return torch.round(x * (127.0 / scale_max)).to(torch.int8)


def ffn_int8_apply(h, wi_q, wi_s, wo_q, wo_s, out_dtype=None):
    """relu FFN with int8 weights + per-row dynamic int8 activations.

    h: [..., d] the ffn_norm output for ONE layer; wi_q [d, f] / wo_q [f, d]
    int8 with f32 scales [1, f] / [1, d]. Returns [..., d] in ``out_dtype``
    (default: h's dtype)."""
    out_dtype = out_dtype or h.dtype
    shape = h.shape
    x = h.reshape(-1, shape[-1]).float()
    sx = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)
    acc = _int8_mm(_quantize_rows(x, sx), wi_q)
    hmid = torch.relu(acc.float() * (sx / 127.0) * wi_s)
    sh = torch.clamp_min(hmid.amax(dim=-1, keepdim=True), 1e-12)
    acc2 = _int8_mm(_quantize_rows(hmid, sh), wo_q)
    y = acc2.float() * (sh / 127.0) * wo_s
    return y.to(out_dtype).reshape(shape)
