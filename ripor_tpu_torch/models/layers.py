"""T5 building blocks in PyTorch.

Port of ripor_tpu/models/layers.py. Numerics follow the T5 v1.0 recipe:
RMSNorm without mean-centering, pre-norm residuals, relative-position
bucket bias in the first layer of each stack only, and unscaled
dot-product attention (the 1/sqrt(d_k) factor lives in the q init).

Every module computes in ``dtype`` and holds its weights in it, except the
RMSNorm scale, which stays float32 as the reference keeps it (its product
is taken in float32 either way). Attention logits and softmax run in
float32, as the reference's ``preferred_element_type=float32`` einsums do.
Parameter names mirror the flax tree (models/convert.py maps one onto the
other). Under tensor parallelism (decode/beam.py::make_tp_beam_search_fn)
a module holds one rank's heads or d_ff columns and its ``tp_group``
attribute, set by the builder (RiporModel.set_tp_group), names the
process group its row-parallel output projection all-reduces over.
Dropout draws its masks from an explicit ``torch.Generator`` on the
activations' device (``dropout``); the stacks in models/t5.py hand each
layer a generator seeded for it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from ripor_tpu_torch.core.mesh import all_reduce_sum
from ripor_tpu_torch.models.config import T5Config

NEG_INF = -1e9  # additive mask value (reference layers.py NEG_INF)


def dropout(x, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity when ``deterministic`` or
    rate is 0. The mask is drawn from ``generator``, a generator on x's
    device."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a generator")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def replay(generator: Optional[torch.Generator]
           ) -> Optional[torch.Generator]:
    """A new generator in ``generator``'s state (None stays None): a
    forward handed it draws the masks another forward handed a replay of
    the same state draws (train/losses.py)."""
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


def _empty(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    """T5 LayerNorm: no mean subtraction, no bias."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = _empty((dim,), torch.float32, device)

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale).to(self.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5 relative-position bucketing (key_pos - query_pos -> bucket id)."""
    ret = torch.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    n_safe = torch.clamp(n, min=1).float()
    val_if_large = max_exact + (
        torch.log(n_safe / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    """Bucketed relative-position bias -> [1, heads, q_len, k_len]."""

    def __init__(self, cfg: T5Config, bidirectional: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.dtype = dtype
        self.rel_embedding = _empty(
            (cfg.relative_attention_num_buckets, cfg.num_heads), dtype, device)

    def forward(self, q_len: int, k_len: int):
        dev = self.rel_embedding.device
        q_pos = torch.arange(q_len, device=dev)[:, None]
        k_pos = torch.arange(k_len, device=dev)[None, :]
        buckets = relative_position_bucket(
            k_pos - q_pos, bidirectional=self.bidirectional,
            num_buckets=self.cfg.relative_attention_num_buckets,
            max_distance=self.cfg.relative_attention_max_distance)
        bias = self.rel_embedding[buckets]                 # [q, k, heads]
        return bias.permute(2, 0, 1)[None].to(self.dtype)  # [1, H, q, k]


def dot_product_attention(q, k, v, bias=None, dtype=torch.float32):
    """Unscaled T5 attention. q: [B, Lq, H, D]; k, v: [B, Lk, H, D];
    bias: additive [B or 1, H, Lq, Lk], added in float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _linear(fan_in, fan_out, dtype, device):
    return nn.Linear(fan_in, fan_out, bias=False, dtype=dtype, device=device)


class Attention(nn.Module):
    """T5 multi-head attention with separately callable projections."""

    tp_group = None

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        inner = cfg.inner_dim
        self.q = _linear(cfg.d_model, inner, dtype, device)
        self.k = _linear(cfg.d_model, inner, dtype, device)
        self.v = _linear(cfg.d_model, inner, dtype, device)
        self.o = _linear(inner, cfg.d_model, dtype, device)
        for p in self.parameters():
            p.requires_grad_(False)

    def _split(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.cfg.num_heads, self.cfg.d_kv)

    def project_q(self, x):
        return self._split(self.q(x))

    def project_kv(self, x):
        return self._split(self.k(x)), self._split(self.v(x))

    def out(self, attn):
        b, l = attn.shape[:2]
        return self.out_flat(attn.reshape(b, l, self.cfg.inner_dim))

    def out_flat(self, attn_flat):
        """Output projection on pre-flattened [B, L, inner] attention.
        Under tensor parallelism each rank holds a head shard and a row
        shard of o, and the partial products all-reduce here, in the
        activations' dtype, as the JAX package's psum takes them."""
        return all_reduce_sum(self.o(attn_flat), self.tp_group)

    def forward(self, x, kv_input=None, bias=None):
        kv_input = x if kv_input is None else kv_input
        q = self.project_q(x)
        k, v = self.project_kv(kv_input)
        return self.out(dot_product_attention(q, k, v, bias=bias,
                                              dtype=self.dtype))


class FeedForward(nn.Module):
    """T5 FFN: wi -> relu -> wo (v1.0) or the gated variant (v1.1)."""

    tp_group = None

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.is_gated:
            self.wi_0 = _linear(cfg.d_model, cfg.d_ff, dtype, device)
            self.wi_1 = _linear(cfg.d_model, cfg.d_ff, dtype, device)
        else:
            self.wi = _linear(cfg.d_model, cfg.d_ff, dtype, device)
        self.wo = _linear(cfg.d_ff, cfg.d_model, dtype, device)
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        if cfg.is_gated:
            # flax nn.gelu defaults to the tanh approximation
            act = {"gated-gelu": lambda h: Fn.gelu(h, approximate="tanh"),
                   "gated-silu": Fn.silu}[cfg.feed_forward_proj]
            h = act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = torch.relu(self.wi(x))
        y = self.wo(dropout(h, cfg.dropout_rate, deterministic, generator))
        return all_reduce_sum(y, self.tp_group)       # row-parallel wo


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, Lk] 1/0 mask -> additive [B, 1, 1, Lk] float32 bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).float()


def causal_bias(length: int, device=None) -> torch.Tensor:
    """Additive [1, 1, L, L] float32 causal mask."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).float()[None, None]
