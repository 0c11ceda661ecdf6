"""Beam gathers: K3 ``out[g, n] = x[g, src[g, n]]`` over rows, K7 the
same over [R, C] blocks, and K6, which is K7 with block row t replaced.

Port of ripor_tpu/ops/beam_gather.py::beam_gather_rows (K3),
::beam_gather_blocks (K7), ::beam_gather_update (K6) and
::reorder_cache_pallas. K3 permutes each step's K|V rows (QFUSE int8
rows on the megarow path, exact or int8 rows on the deferred path, the
stacked kv_new on the non-deferred path) into the new beam order; K6 is
the non-deferred path's cache reorder with the position-t insert; K7 the
write-then-attend path's cache reorder, whose slot t is already written.
The CUDA kernels are csrc/beam_gather_rows.cu, csrc/beam_gather_blocks.cu
and csrc/beam_gather_update.cu. The reference's padding (C to 128, N to
its DMA chunk) and its ``dest`` aliasing argument served the TPU's tiling
and XLA's buffer assignment; here K6 and K7 may be handed their output
buffer.
"""
from __future__ import annotations

from typing import Optional

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


def reorder_cache_pallas(cache_tree, src: torch.Tensor):
    """Counterpart of the reference's reorder_cache_pallas: reorder a
    sequence or dict of [B, N, ...] tensors (one dtype, one row size) by
    src [B, N] with one K3 launch over their stacked rows. Returns the
    same container with tensors of the same shapes."""
    keys = list(cache_tree) if isinstance(cache_tree, dict) else None
    leaves = list(cache_tree.values()) if keys else list(cache_tree)
    B, N = src.shape
    stacked = torch.stack([x.reshape(B, N, -1) for x in leaves])
    n, Fr = stacked.shape[0], stacked.shape[-1]
    out = beam_gather_rows(stacked.view(n * B, N, Fr),
                           src.repeat(n, 1)).view(n, B, N, Fr)
    new = [out[i].reshape(x.shape) for i, x in enumerate(leaves)]
    return dict(zip(keys, new)) if keys else type(cache_tree)(new)


def _check_blocks_out(cache, out):
    require(tuple(out.shape) == tuple(cache.shape)
            and out.dtype == cache.dtype,
            f"out {tuple(out.shape)}/{out.dtype} must match cache "
            f"{tuple(cache.shape)}/{cache.dtype}")


def beam_gather_blocks_plain(cache: torch.Tensor, src: torch.Tensor,
                             out: Optional[torch.Tensor] = None):
    """Plain version of K7; writes ``out`` (when given) and returns it."""
    res = cache[torch.arange(cache.shape[0], device=src.device)[:, None],
                src.long()]
    return res if out is None else out.copy_(res)


def beam_gather_blocks(cache: torch.Tensor, src: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[g, n] = cache[g, src[g, n]] over [G, N, R, C] blocks of any
    dtype. src: [G, N] int32 with values in [0, N); out: an optional
    distinct buffer shaped like cache (written, returned), else a new
    one."""
    require(cache.dim() == 4, f"cache must be [G, N, R, C], got "
                              f"{tuple(cache.shape)}")
    G, N, R, C = cache.shape
    require(tuple(src.shape) == (G, N), f"src {tuple(src.shape)} != {(G, N)}")
    tensors = (cache, src)
    if out is not None:
        _check_blocks_out(cache, out)
        tensors += (out,)
    if device_kind(*tensors) == "cpu":
        return beam_gather_blocks_plain(cache, src, out)
    require(src.dtype == torch.int32, f"src must be int32, got {src.dtype}")
    if out is None:
        out = torch.empty_like(cache)
    require(all(x.is_contiguous() for x in (cache, src, out)),
            "beam_gather_blocks needs contiguous tensors")
    require_disjoint(cache, out, "out")
    fn = kernel_fn("beam_gather_blocks", "beam_gather_blocks", 3, 3)
    with torch.cuda.device(cache.device):
        rc = fn(cache.data_ptr(), src.data_ptr(), out.data_ptr(), G, N,
                R * C * cache.element_size(),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "beam_gather_blocks")
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
    _check_blocks_out(cache, out)
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
