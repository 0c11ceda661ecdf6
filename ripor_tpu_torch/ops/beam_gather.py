"""Beam gathers: K3 ``out[g, n] = x[g, src[g, n]]`` over rows, and K6
the same over [R, C] blocks with block row t replaced.

Port of ripor_tpu/ops/beam_gather.py::beam_gather_rows (K3) and
::beam_gather_update (K6). K3 permutes each step's K|V rows (QFUSE int8
rows on the megarow path, exact or int8 rows on the deferred path, the
stacked kv_new on the non-deferred path) into the new beam order; K6 is
the non-deferred path's cache reorder with the position-t insert. The
CUDA kernels are csrc/beam_gather_rows.cu and csrc/beam_gather_update.cu.
The reference's ``dest`` aliasing argument served XLA's buffer
assignment; here the caller hands K6 its output buffer.
"""
from __future__ import annotations

import torch

from ripor_tpu_torch.ops._build import (check_launch, device_kind,
                                        kernel_fn, require,
                                        require_disjoint)


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


def beam_gather_update_plain(cache, kv_gathered, src, t: int, out):
    """Plain version of K6; writes ``out`` and returns it."""
    G = cache.shape[0]
    out.copy_(cache[torch.arange(G, device=src.device)[:, None],
                    src.long()])
    out[:, :, t] = kv_gathered
    return out


def beam_gather_update(cache: torch.Tensor, kv_gathered: torch.Tensor,
                       src: torch.Tensor, t: int,
                       out: torch.Tensor) -> torch.Tensor:
    """out[g, n] = cache[g, src[g, n]] with row ``t`` replaced by
    kv_gathered[g, n]. cache: [G, N, R, C]; kv_gathered: [G, N, C] (already
    in the new beam order); src: [G, N] int32 with values in [0, N); t:
    Python int in [0, R); out: a distinct buffer shaped like cache
    (written, returned)."""
    G, N, R, C = cache.shape
    require(tuple(src.shape) == (G, N), f"src {tuple(src.shape)} != {(G, N)}")
    require(tuple(kv_gathered.shape) == (G, N, C)
            and kv_gathered.dtype == cache.dtype,
            f"kv_gathered {tuple(kv_gathered.shape)}/{kv_gathered.dtype} != "
            f"{(G, N, C)}/{cache.dtype}")
    require(tuple(out.shape) == tuple(cache.shape)
            and out.dtype == cache.dtype,
            f"out {tuple(out.shape)}/{out.dtype} must match cache "
            f"{tuple(cache.shape)}/{cache.dtype}")
    require(0 <= t < R, f"slot {t} outside [0, {R})")
    if device_kind(cache, kv_gathered, src, out) == "cpu":
        return beam_gather_update_plain(cache, kv_gathered, src, t, out)
    require(src.dtype == torch.int32, f"src must be int32, got {src.dtype}")
    require(all(x.is_contiguous() for x in (cache, kv_gathered, src, out)),
            "beam_gather_update needs contiguous tensors")
    require_disjoint(cache, out, "out")
    fn = kernel_fn("beam_gather_update", "beam_gather_update", 4, 5)
    with torch.cuda.device(cache.device):
        rc = fn(cache.data_ptr(), kv_gathered.data_ptr(), src.data_ptr(),
                out.data_ptr(), G, N, R,
                C * cache.element_size(), t,
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "beam_gather_update")
    return out
