"""Beam row gather: ``out[g, n] = x[g, src[g, n]]``.

Port of ripor_tpu/ops/beam_gather.py::beam_gather_rows (K3). On the main
path it permutes each step's QFUSE rows [B, N, L*RW] (or exact K|V rows)
into the new beam order. The CUDA kernel is csrc/beam_gather_rows.cu.
"""
from __future__ import annotations

import torch

from ripor_tpu_torch.ops._build import (check_launch, device_kind,
                                        kernel_fn, require)


def beam_gather_rows_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version: x [G, N, Fr] any dtype; src [G, N] int."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], src.long()]


def beam_gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[g, n] = x[g, src[g, n]]. x: [G, N, Fr]; src: [G, N] int32 with
    values in [0, N) (not checked on the device: that would sync)."""
    G, N, Fr = x.shape
    require(tuple(src.shape) == (G, N), f"src {tuple(src.shape)} != {(G, N)}")
    if device_kind(x, src) == "cpu":
        return beam_gather_rows_plain(x, src)
    require(src.dtype == torch.int32, f"src must be int32, got {src.dtype}")
    require(x.is_contiguous() and src.is_contiguous(),
            "beam_gather_rows needs contiguous tensors")
    out = torch.empty_like(x)
    fn = kernel_fn("beam_gather_rows", "beam_gather_rows", 3, 3)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), src.data_ptr(), out.data_ptr(), G, N,
                Fr * x.element_size(),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "beam_gather_rows")
    return out
