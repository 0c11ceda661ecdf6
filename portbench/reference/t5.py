"""The plain reference: RIPOR's generative retriever written from its
published description, in float32 and plain PyTorch operations.

A T5 v1.0 encoder-decoder (RMSNorm without mean or bias, pre-norm
residuals, unscaled dot-product attention, bucketed relative-position
bias from the first layer's table shared by every layer of a stack, ReLU
feed-forward) whose decoder reads and scores per-position codebooks: the
input at position t > 0 is ``codebooks[t-1][c_{t-1}]``, at t = 0 a learned
start embedding, and the score of code c at position t is the inner
product of the final hidden state with ``codebooks[t][c]`` (raw logits, no
softmax, summed over the M positions: RIPOR's sequence score).

It imports nothing of the program. It takes the benchmark's weights by
their T5 parameter names and works out everything else itself: the
relative-position buckets, the masks and, where a cell states a quantized
cache, the self-attention history rounded as that cache stores it
(per-head power-of-two scales, int8 or int4 levels; position t's own key
and value stay exact).

``precision="float8"`` is the control: every operand of every matrix
product is rounded to float8 e4m3 with one scale a tensor, the step below
the bfloat16 the configurations state.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

LEVELS = {"int8": (-128, 127), "int4": (-8, 7)}
E4M3_MAX = 448.0


@contextmanager
def exact_float32():
    """float32 products without TF32 on the card, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def relative_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """T5's bucket of a relative position (key minus query)."""
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out += (rel > 0).long() * num_buckets
        n = rel.abs()
    else:
        n = (-rel).clamp(min=0)
    exact = num_buckets // 2
    large = exact + (torch.log(n.clamp(min=1).float() / exact)
                     / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=num_buckets - 1))


def history_rounding(x: torch.Tensor, heads: int, quant: str) -> torch.Tensor:
    """Rows [..., heads * D] as a quantized cache stores them: each head's
    D values share the scale 2^ceil(log2(absmax / qmax)) and take integer
    levels in LEVELS[quant]."""
    lo, hi = LEVELS[quant]
    g = x.reshape(*x.shape[:-1], heads, -1)
    am = g.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    scale = torch.exp2(torch.ceil(torch.log2(am / hi)).clamp(-100, 100))
    return (torch.round(g / scale).clamp(lo, hi) * scale).reshape(x.shape)


class Reference:
    """weights: name -> tensor (any dtype, any device), the benchmark's;
    dims: the configuration's widths (d_model, d_kv, num_heads, d_ff,
    num_layers, num_decoder_layers, relative_attention_num_buckets,
    relative_attention_max_distance, layer_norm_epsilon, M, K).
    ``cache``: None, "int8" or "int4" (the cell's stated cache);
    ``precision``: "float32", or "float8" for the control."""

    def __init__(self, weights: Dict[str, torch.Tensor], dims: dict,
                 device, precision: str = "float32",
                 cache: Optional[str] = None):
        if precision not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"precision {precision!r}")
        if cache not in (None, "int8", "int4"):
            raise ValueError(f"cache {cache!r}")
        self.dims = dims
        self.device = torch.device(device)
        self.precision = precision
        self.cache = cache
        self.w = {k: v.detach().to(self.device, torch.float32)
                  for k, v in weights.items()}
        self.H = dims["num_heads"]
        self.D = dims["d_kv"]

    # -- arithmetic ---------------------------------------------------------

    def _rnd(self, x):
        if self.precision == "float32" or not x.numel():
            return x
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def _mm(self, a, b):
        """a @ b with the precision's operand rounding."""
        return self._rnd(a) @ self._rnd(b)

    def _hold(self, x):
        """x as the activations hold it: bfloat16 unless in float32."""
        if self.precision == "float32":
            return x
        return x.to(torch.bfloat16).float()

    def _linear(self, x, name):
        return self._hold(self._mm(x, self.w[name].T))

    def _norm(self, x, name):
        var = x.square().mean(-1, keepdim=True)
        return self._hold(x * torch.rsqrt(var + self.dims["layer_norm_epsilon"])
                          * self.w[name])

    def _heads(self, x):
        return x.reshape(*x.shape[:-1], self.H, self.D).transpose(-3, -2)

    def _merge(self, x):
        x = x.transpose(-3, -2)
        return x.reshape(*x.shape[:-2], self.H * self.D)

    def _bias(self, stack, q_len, k_len, bidirectional):
        q = torch.arange(q_len, device=self.device)[:, None]
        k = torch.arange(k_len, device=self.device)[None, :]
        b = relative_bucket(k - q, bidirectional,
                            self.dims["relative_attention_num_buckets"],
                            self.dims["relative_attention_max_distance"])
        return self.w[f"{stack}.rel_bias.rel_embedding"][b].permute(2, 0, 1)

    def _attend(self, q, k, v, bias):
        s = self._mm(q, k.transpose(-1, -2))
        if bias is not None:
            s = s + bias
        return self._hold(self._mm(torch.softmax(s, -1), v))

    def _ffn(self, x, p):
        h = torch.relu(self._linear(x, f"{p}.ffn.wi.weight"))
        return self._linear(h, f"{p}.ffn.wo.weight")

    # -- the model ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, ids) -> torch.Tensor:
        """Token ids of one query (no padding) -> encoder states [S, d]."""
        ids = torch.as_tensor(ids, device=self.device, dtype=torch.long)
        x = self.w["shared.weight"][ids]
        bias = self._bias("encoder", len(ids), len(ids), True)
        for i in range(self.dims["num_layers"]):
            p = f"encoder.layers.{i}"
            h = self._norm(x, f"{p}.attn_norm.scale")
            q, k, v = (self._heads(self._linear(h, f"{p}.attn.{n}.weight"))
                       for n in "qkv")
            x = self._hold(x + self._linear(
                self._merge(self._attend(q, k, v, bias)), f"{p}.attn.o.weight"))
            x = self._hold(x + self._ffn(self._norm(x, f"{p}.ffn_norm.scale"),
                                         p))
        return self._norm(x, "encoder.final_norm.scale")

    def cross(self, encs):
        """Each decoder layer's keys and values of the queries' encoder
        states, padded to the longest: ([Q, H, S, D] keys, values, and
        the [Q, 1, 1, S] bias that masks the padding)."""
        S = max(len(e) for e in encs)
        pad = torch.stack([torch.cat([e, e.new_zeros(S - len(e), e.shape[1])])
                           for e in encs])                     # [Q, S, d]
        bias = torch.stack([torch.arange(S, device=self.device) >= len(e)
                            for e in encs]).float() * -1e9
        out = []
        for i in range(self.dims["num_decoder_layers"]):
            p = f"decoder.layers.{i}.cross_attn"
            out.append((self._heads(self._linear(pad, f"{p}.k.weight")),
                        self._heads(self._linear(pad, f"{p}.v.weight")),
                        bias[:, None, None, :]))
        return out

    def _keep(self, row):
        """A key or value row as the history holds it."""
        return row if self.cache is None else history_rounding(
            row, self.H, self.cache)

    def step(self, x, hist, t: int, cross, query):
        """Decoder position t for n sequences: x [n, d] their inputs,
        hist[l] = (keys, values) [n, H, t, D] of positions before t as the
        cache holds them, query [n] the index of each one's query in
        ``cross``. Returns the hidden states [n, d] and the history with
        position t appended. Position t attends to its own key and value
        exactly."""
        bias = self._bias("decoder", t + 1, t + 1, False)[:, t]   # [H, t+1]
        new = []
        for i in range(self.dims["num_decoder_layers"]):
            p = f"decoder.layers.{i}"
            h = self._norm(x, f"{p}.self_attn_norm.scale")
            q, k, v = (self._linear(h, f"{p}.self_attn.{n}.weight")
                       for n in "qkv")
            q, kh, vh = (r.reshape(-1, self.H, 1, self.D) for r in
                         (q, self._keep(k), self._keep(v)))
            k, v = (r.reshape(-1, self.H, 1, self.D) for r in (k, v))
            keys, values = hist[i]
            s = torch.cat([self._mm(q, keys.transpose(-1, -2)),
                           (self._rnd(q) * self._rnd(k)).sum(-1, True)], -1)
            pr = torch.softmax(s + bias[:, None, :], -1)        # [n, H, 1, t+1]
            a = self._hold(self._mm(pr[..., :t], values)
                           + self._rnd(pr[..., t:]) * self._rnd(v))
            x = self._hold(x + self._linear(a.reshape(len(x), -1),
                                            f"{p}.self_attn.o.weight"))
            new.append((torch.cat([keys, kh], 2), torch.cat([values, vh], 2)))
            h = self._norm(x, f"{p}.cross_attn_norm.scale")
            q = self._linear(h, f"{p}.cross_attn.q.weight").reshape(
                -1, self.H, 1, self.D)
            ck, cv, cb = cross[i]
            a = self._attend(q, ck[query], cv[query], cb[query])
            x = self._hold(x + self._linear(a.reshape(len(x), -1),
                                            f"{p}.cross_attn.o.weight"))
            x = self._hold(x + self._ffn(self._norm(x, f"{p}.ffn_norm.scale"),
                                         p))
        return self._norm(x, "decoder.final_norm.scale"), new

    def _empty_history(self, n):
        z = torch.zeros(n, self.H, 0, self.D, device=self.device)
        return [(z, z)] * self.dims["num_decoder_layers"]

    def _input(self, t: int, prev: torch.Tensor) -> torch.Tensor:
        if t == 0:
            return self.w["start_embed"].expand(len(prev), -1)
        return self.w["codebooks"][t - 1][prev]

    def _logits(self, h, t: int, codes=None):
        books = self.w["codebooks"][t]
        if codes is None:
            return self._mm(h, books.T)
        return (self._rnd(h) * self._rnd(books[codes])).sum(-1)

    @torch.no_grad()
    def path_scores(self, encs, paths, block: int = 2048):
        """Teacher-forced scores: encs, the queries' encoder states;
        paths[i], query i's codes [P_i, M]. Returns, for each query, the
        [P_i] sums over t of the logit of codes[p, t] at position t after
        codes[p, :t] (float64)."""
        cross = self.cross(encs)
        codes = torch.cat([torch.as_tensor(c, dtype=torch.long)
                           for c in paths]).to(self.device)
        query = torch.cat([torch.full((len(c),), i, dtype=torch.long)
                           for i, c in enumerate(paths)]).to(self.device)
        out = []
        for c, qi in zip(codes.split(block), query.split(block)):
            hist = self._empty_history(len(c))
            total = torch.zeros(len(c), dtype=torch.float64,
                                device=self.device)
            for t in range(c.shape[1]):
                h, hist = self.step(self._input(t, c[:, t - 1] if t
                                                else c[:, 0]),
                                    hist, t, cross, qi)
                total += self._logits(h, t, c[:, t]).double()
            out.append(total)
        return list(torch.cat(out).cpu().split([len(c) for c in paths]))

    @torch.no_grad()
    def search(self, encs, runs, beams: int, topk: int):
        """The trie-constrained beam search of each query: at each
        position every beam extends by each code its run of the corpus
        continues with, and each query's ``beams`` best sums of logits go
        on. Returns, for each query, the documents of its best beams, best
        first, cut to ``topk``."""
        cross = self.cross(encs)
        Q = len(encs)
        query = np.arange(Q)
        lo, hi = np.zeros(Q, np.int64), np.full(Q, runs.n)
        score = np.zeros(Q)
        prev = torch.zeros(Q, dtype=torch.long, device=self.device)
        hist = self._empty_history(Q)
        for t in range(runs.M):
            h, hist = self.step(self._input(t, prev), hist, t, cross,
                                torch.from_numpy(query).to(self.device))
            logits = self._logits(h, t).double().cpu().numpy()   # [n, K]
            parent, code, clo, chi = runs.children(lo, hi, t)
            cand = score[parent] + logits[parent, code]
            cq = query[parent]
            order = np.lexsort((-cand, cq))       # query-major, best first
            first = np.searchsorted(cq[order], cq[order])
            keep = order[np.arange(len(order)) - first < beams]
            query, score = cq[keep], cand[keep]
            lo, hi = clo[keep], chi[keep]
            prev = torch.from_numpy(code[keep].astype(np.int64)).to(
                self.device)
            back = torch.from_numpy(parent[keep]).to(self.device)
            hist = [(k[back], v[back]) for k, v in hist]
        out = []
        for i in range(Q):
            mine = np.flatnonzero(query == i)
            docs = []
            for j in mine[np.argsort(-score[mine], kind="stable")]:
                docs.extend(runs.documents(lo[j], hi[j]).tolist())
                if len(docs) >= topk:
                    break
            out.append(np.asarray(docs[:topk]))
        return out
