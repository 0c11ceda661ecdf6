"""One-position cached self-attention: K5 and K8.

Port of ripor_tpu/ops/step_attention.py.

K5 ``step_attention_fused`` is the attention of the non-deferred decode:
for one layer of the cache [L, 2, B, N, Mc, F] (K plane, then V plane),
each beam's query attends to slots [0, t) of its history plus position
t's own k/v, which are folded into the softmax instead of being written to
the cache first (the beam reorder, ops/beam_gather.py::beam_gather_update,
inserts them). All math is f32, whatever the input dtype, as in the
reference's kernel. CUDA kernel: csrc/step_attention_fused.cu.

K8 ``step_attention`` is the attention of the write-then-attend decode:
position t's k/v are already written at slot t of separate K and V caches
[B, N, Mc, F], and the softmax runs over the Mc slots alone. Its rounding
points are the reference kernel's own: exact f32 k*q products, f32
softmax, probabilities rounded to q's dtype, f32 weighted V sum, output in
q's dtype. CUDA kernel: csrc/step_attention.cu.

Both kernels run on the staged core (csrc/attend_staged.cuh): each beam's
K and V planes are staged in shared memory by bulk async copies, in slot
chunks where they do not fit one stage; ops/staging.py plans the stages.
The TPU kernels' chunk, padding and block pipeline have no counterpart
here: they served the TPU's VMEM.
"""
from __future__ import annotations

import torch

from ripor_tpu_torch.ops._build import (check_launch, device_kind,
                                        kernel_fn, require)
from ripor_tpu_torch.ops.attend_reorder import attend_plain
from ripor_tpu_torch.ops.staging import stage_plan


def _check_fused(q, k_new, v_new, cache, layer, bias_hist, bias_new,
                 num_heads):
    B, N, F = q.shape
    require(cache.dim() == 6, f"cache must be [L, 2, B, N, Mc, F], got "
                              f"{tuple(cache.shape)}")
    L, two, _, _, Mc, _ = cache.shape
    require(two == 2 and tuple(cache.shape[2:4]) == (B, N)
            and cache.shape[5] == F,
            f"cache {tuple(cache.shape)} does not match q {tuple(q.shape)}")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        require(tuple(x.shape) == (B, N, F),
                f"{name} {tuple(x.shape)} != {(B, N, F)}")
    require(F % num_heads == 0, f"F={F} not divisible by H={num_heads}")
    require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    require(tuple(bias_hist.shape) == (Mc, num_heads),
            f"bias_hist {tuple(bias_hist.shape)} != {(Mc, num_heads)}")
    require(tuple(bias_new.shape) == (1, num_heads),
            f"bias_new {tuple(bias_new.shape)} != {(1, num_heads)}")


def step_attention_fused_plain(q, k_new, v_new, cache, layer: int,
                               bias_hist, bias_new, num_heads: int):
    """Plain version of K5: attend_plain with f32 dots over layer
    ``layer``'s K and V planes."""
    _check_fused(q, k_new, v_new, cache, layer, bias_hist, bias_new,
                 num_heads)
    return attend_plain(q, k_new, v_new, cache[layer, 0].float(),
                        cache[layer, 1].float(), bias_hist, bias_new,
                        num_heads, torch.float32)


def step_attention_fused(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, cache: torch.Tensor,
                         layer: int, bias_hist: torch.Tensor,
                         bias_new: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """One-position cached self-attention for one layer.

    q, k_new, v_new: [B, N, F] position t's projections (not in the
    cache); cache: [L, 2, B, N, Mc, F] in q's dtype, history in slots
    [0, t); layer: Python int; bias_hist: [Mc, H] f32 (relpos row, slots
    >= t masked); bias_new: [1, H] f32 (position t's self bias). Returns
    [B, N, F] in q's dtype."""
    _check_fused(q, k_new, v_new, cache, layer, bias_hist, bias_new,
                 num_heads)
    tensors = (q, k_new, v_new, cache, bias_hist, bias_new)
    if device_kind(*tensors) == "cpu":
        return step_attention_fused_plain(q, k_new, v_new, cache, layer,
                                          bias_hist, bias_new, num_heads)
    B, N, F = q.shape
    Mc = cache.shape[4]
    require(q.dtype in (torch.bfloat16, torch.float32)
            and all(x.dtype == q.dtype for x in (k_new, v_new, cache)),
            f"q, k_new, v_new and cache must share dtype bf16 or f32, got "
            f"{[x.dtype for x in (q, k_new, v_new, cache)]}")
    require(bias_hist.dtype == torch.float32
            and bias_new.dtype == torch.float32, "biases must be float32")
    require(all(x.is_contiguous() for x in tensors),
            "step_attention_fused needs contiguous tensors")
    esz = q.element_size()
    plan = stage_plan(None, esz, esz, Mc, F, num_heads, planes=True)
    attn = torch.empty_like(q)
    fn = kernel_fn("step_attention_fused", "step_attention_fused", 7, 9)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                cache.data_ptr(), bias_hist.data_ptr(), bias_new.data_ptr(),
                attn.data_ptr(), B * N, Mc, F, num_heads, layer,
                int(q.dtype == torch.float32), plan.chunk_slots, plan.stages,
                plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "step_attention_fused")
    return attn


def _check_step(q, cache_k, cache_v, bias, num_heads):
    B, N, F = q.shape
    require(cache_k.dim() == 4 and tuple(cache_k.shape[:2]) == (B, N)
            and cache_k.shape[3] == F,
            f"cache_k {tuple(cache_k.shape)} is not [B, N, Mc, F] for q "
            f"{tuple(q.shape)}")
    require(cache_v.shape == cache_k.shape,
            f"cache_v {tuple(cache_v.shape)} != cache_k "
            f"{tuple(cache_k.shape)}")
    require(F % num_heads == 0, f"F={F} not divisible by H={num_heads}")
    Mc = cache_k.shape[2]
    require(tuple(bias.shape) == (Mc, num_heads),
            f"bias {tuple(bias.shape)} != {(Mc, num_heads)}")


def step_attention_plain(q, cache_k, cache_v, bias, num_heads: int):
    """Plain version of K8, with its rounding points: f32 k*q products and
    softmax, probabilities cast to q's dtype, f32 weighted V sum."""
    _check_step(q, cache_k, cache_v, bias, num_heads)
    B, N, F = q.shape
    Mc = cache_k.shape[2]
    H, D = num_heads, F // num_heads
    kq = cache_k.float() * q.float()[:, :, None, :]        # [B, N, Mc, F]
    scores = kq.reshape(B, N, Mc, H, D).sum(-1) + bias.float()
    probs = torch.softmax(scores, dim=2).to(q.dtype)       # [B, N, Mc, H]
    pe = probs.float().repeat_interleave(D, dim=-1)        # [B, N, Mc, F]
    return (pe * cache_v.float()).sum(2).to(q.dtype)


def step_attention(q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, bias: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """One-position cached self-attention over separate K and V caches.

    q: [B, N, F]; cache_k, cache_v: [B, N, Mc, F] in q's dtype with the
    current position's k/v already written at its slot; bias: [Mc, H] f32
    (relpos bias + NEG_INF for slots > t). Returns [B, N, F] in q's
    dtype."""
    _check_step(q, cache_k, cache_v, bias, num_heads)
    tensors = (q, cache_k, cache_v, bias)
    if device_kind(*tensors) == "cpu":
        return step_attention_plain(q, cache_k, cache_v, bias, num_heads)
    B, N, F = q.shape
    require(q.dtype in (torch.bfloat16, torch.float32)
            and cache_k.dtype == q.dtype and cache_v.dtype == q.dtype,
            f"q and the caches must share dtype bf16 or f32, got "
            f"{[x.dtype for x in (q, cache_k, cache_v)]}")
    require(bias.dtype == torch.float32, "bias must be float32")
    require(all(x.is_contiguous() for x in tensors),
            "step_attention needs contiguous tensors")
    Mc, esz = cache_k.shape[2], q.element_size()
    plan = stage_plan(None, esz, esz, Mc, F, num_heads, planes=True,
                      new=False)
    out = torch.empty_like(q)
    fn = kernel_fn("step_attention", "step_attention", 5, 8)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                bias.data_ptr(), out.data_ptr(), B * N, Mc, F, num_heads,
                int(q.dtype == torch.float32), plan.chunk_slots, plan.stages,
                plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "step_attention")
    return out
