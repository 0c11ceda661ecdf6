"""Trie-constrained beam search, in PyTorch.

Port of ripor_tpu/decode/beam.py (``make_beam_search_fn``) on its four
decode paths. Per step, after the projections of each layer:

  megarow (default when the segment spans are even):
    K1 reorder of all layers (pending beam permutation + slot t-1 insert)
    -> per layer K2 step attention (QFUSE: it also emits quantized rows)
  deferred per-layer (megarow=False):
    per layer K4: reorder of that layer + slot t-1 insert + attention
  non-deferred (deferred=False; the default when a span is odd):
    per layer K5 step attention over the stacked cache
  write-then-attend (use_pallas_gather=False, the reference's XLA path):
    per layer k/v written at slot t of the stacked cache, then K8

  -> cross-attention, FFN -> codebook-head logits -> trie mask -> top-k
  -> megarow, deferred: K3 gather of this step's K|V rows into the new
     beam order; non-deferred: K3 + K6, the cache reorder with the slot t
     insert; write-then-attend: K7, the cache reorder (both every step
     but the last)

The two deferred paths carry the pending reorder as (src_prev, kvg): the
next step completes it while copying the cache into the other buffer of a
pair that is swapped by reference each step; the other two paths swap
their pair at each reorder. The whole loop issues no host sync (no
``.item()``, no tensor in a Python condition), so on the card the host
runs ahead and the device never waits for it.

Score semantics match the reference: raw cumulative logits, no EOS, every
sequence runs all M steps, optional log-softmax in the model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.ops.attend_reorder import quantize_rows_plain
from ripor_tpu_torch.ops.beam_gather import (beam_gather_blocks,
                                             beam_gather_rows,
                                             beam_gather_update)
from ripor_tpu_torch.ops.int8_ffn import quantize_ffn

NEG_INF = -1e30


@dataclasses.dataclass
class BeamSearchOutput:
    """scores/codes/groups sorted best-first along the beam axis.

    groups[b, n] is the smtid-group index (row of trie.unique_codes) the
    beam landed on, or -1 for dead beams (score == NEG_INF)."""

    scores: np.ndarray   # [B, N] float32
    codes: np.ndarray    # [B, N, M] int
    groups: np.ndarray   # [B, N] int32


def resolve_device(device=None) -> torch.device:
    """The entry points' device: "cuda" unless the caller asks otherwise.
    Without CUDA a request for it raises — nothing falls back to the CPU
    quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ripor_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held in int64 (torch has no popcount
    op and thin uint32 support)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _trie_allowed(tables, state, t: int, K: int):
    """Allowed-token mask [B, N, K] bool for beam states [B, N].

    internal (>= 0): unpack the node's bitmask row; singleton chain
    (<= -2): one-hot of the group's code at step t; dead (-1): none."""
    B, N = state.shape
    row = tables.bits[torch.clamp(state, min=0)]             # [B, N, W]
    shifts = torch.arange(32, device=state.device)
    unpacked = (row[..., None] >> shifts) & 1                # [B, N, W, 32]
    internal_allowed = unpacked.reshape(B, N, -1)[:, :, :K].bool()
    group = torch.clamp(-2 - state, 0, tables.unique_codes.shape[0] - 1)
    chain_tok = tables.unique_codes[group, t].long()         # [B, N]
    chain_allowed = torch.nn.functional.one_hot(chain_tok, K).bool()
    is_internal = (state >= 0)[:, :, None]
    is_chain = (state <= -2)[:, :, None]
    return torch.where(is_internal, internal_allowed,
                       is_chain & chain_allowed)


def _trie_child(tables, state, tok):
    """Child entry for the chosen (beam, token) pairs by rank addressing:
    edge = node_base[node] + popcount(bits[node] & mask_below(tok)).
    Non-internal states give an arbitrary (clamped, in-range) entry that
    the caller discards."""
    node = torch.clamp(state, min=0)
    row = tables.bits[node]                                  # [B, N, W]
    W = row.shape[-1]
    w = (tok // 32)[..., None]
    r = (tok % 32)[..., None]
    widx = torch.arange(W, device=tok.device)[None, None, :]
    partial = (torch.ones_like(r) << r) - 1
    wmask = torch.where(widx < w, 0xFFFFFFFF,
                        torch.where(widx == w, partial, 0))
    rank = _popcount32(row & wmask).sum(-1)
    e = tables.node_base[node] + rank
    # a dead or chain state reads node 0 with any token: keep the index
    # inside the table (the reference's gather clamps implicitly)
    e = torch.clamp(e, max=tables.edge_child.shape[0] - 1)
    return tables.edge_child[e].long()


def _segment_bounds(M: int, cache_segments: int):
    """Equal step spans; segment s decodes steps [bounds[s-1], bounds[s])
    with a cache of bounds[s] slots."""
    seg = max(1, min(cache_segments, M))
    bounds = sorted(set(round(M * (s + 1) / seg) for s in range(seg)))
    bounds[-1] = M
    return bounds


def _reorder_cache(cache, src, kv_new, t: int, out):
    """Reorder of the stacked cache: out = cache gathered along the beam
    axis by src [B, N], over the L*2*B planes with src tiled. cache, out:
    [L, 2, B, N, Mc, F]. Non-deferred path: kv_new [L, 2, B, N, F], and
    slot t := this step's K/V rows in the new beam order (K3 permutes
    kv_new, then K6 moves the cache). Write-then-attend path: kv_new is
    None, slot t is already written, and K7 moves the cache."""
    L, two, B, N, Mc, F = cache.shape
    G = L * two * B
    src_rep = src.repeat(L * two, 1)
    if kv_new is None:
        beam_gather_blocks(cache.view(G, N, Mc, F), src_rep,
                           out.view(G, N, Mc, F))
        return out
    kvg = beam_gather_rows(kv_new.reshape(G, N, F), src_rep)
    beam_gather_update(cache.view(G, N, Mc, F), kvg, src_rep, t,
                       out.view(G, N, Mc, F))
    return out


def _grow(buf: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """buf zero-padded along ``dim`` to ``size`` (a cache growing to the
    next segment's slot count; new slots are zero, see init_cache_*)."""
    shape = list(buf.shape)
    shape[dim] = size
    grown = buf.new_zeros(shape)
    grown.narrow(dim, 0, buf.shape[dim]).copy_(buf)
    return grown


def make_beam_search_fn(cfg: RiporConfig, num_beams: int,
                        constrained: bool = True,
                        max_steps: Optional[int] = None,
                        dtype=torch.bfloat16,
                        use_pallas_gather: Optional[bool] = True,
                        cache_segments: int = 4,
                        deferred: Optional[bool] = None,
                        kv_cache_int8: bool = False,
                        kv_cache_quant: Optional[str] = None,
                        kvg_quant_xla: Optional[bool] = None,
                        megarow: Optional[bool] = None,
                        ffn_int8: Optional[bool] = None,
                        device=None):
    """Build a beam-search function.

    Returns fn(model, input_ids, attention_mask, tables) -> (scores [B, N]
    float32, codes [B, N, M], states [B, N]) as tensors on ``device``.
    ``model`` is a RiporModel in ``dtype`` on ``device``; ``tables`` come
    from trie.tables_to_torch (for unconstrained search pass
    constrained=False and tables_to_torch(dummy_tables(M))).

    Arguments select the path and are validated as the reference selects
    and validates them, so the same calls are accepted and refused.
    ``cache_segments``: the cache grows over that many equal step spans
    (M/S, 2M/S, ..., M slots), which cuts reorder and attention bytes.
    ``use_pallas_gather`` (default True, on every device; None means
    True) picks the reference's kernel paths; False its XLA path, here
    the write-then-attend path (K8 + K7), which turns the megarow default
    off and leaves ``deferred`` on by default only for a quantized cache.
    ``megarow`` (default: on when every span is even, ``deferred`` is not
    False and use_pallas_gather is on) takes the megarow path;
    ``megarow=False`` with even spans the deferred per-layer path;
    ``deferred=False``, or odd spans, the non-deferred path (or, with
    use_pallas_gather=False, the write-then-attend path), which holds
    exact caches only. ``kv_cache_quant``
    "int8"/"int4" (or kv_cache_int8=True) stores the cache quantized and
    needs a deferred path. On the megarow path K2 emits each step's rows
    already quantized (QFUSE), the only quantized megarow dataflow
    ported, bit-identical to the others by the reference's own test. On
    the deferred path K4 quantizes step t-1's exact rows as it inserts
    them, unless ``kvg_quant_xla`` (int8 caches only) quantizes them once
    per step before the gather; on the megarow path ``kvg_quant_xla`` is
    subsumed by QFUSE and has no effect. ``ffn_int8=True`` runs the
    decode-step FFN with per-channel int8 weights (quantized once per
    call) and per-row int8 activations (ops/int8_ffn.py), on the megarow
    and deferred paths and for the non-gated FFN only, as the reference
    (its ValueErrors otherwise); None means off.

    The reference's other TPU knobs — the RIPOR_* switches, chunk and
    layer-group picks, the ceil-8 slot rounding and the beam padding —
    have no counterpart: they served the TPU's tiling and VMEM. Where the
    reference's default for use_pallas_gather follows the backend, the
    port's is True everywhere, so a call without it keeps its kernel
    path.
    """
    M = max_steps or cfg.M
    N = num_beams
    K = cfg.K
    L = cfg.t5.num_decoder_layers
    H = cfg.t5.num_heads
    if kv_cache_quant not in (None, "int8", "int4"):
        raise ValueError(f"kv_cache_quant must be int8/int4/None, "
                         f"got {kv_cache_quant!r}")
    quant = kv_cache_quant or ("int8" if kv_cache_int8 else None)
    if use_pallas_gather is None:
        use_pallas_gather = True
    bounds = _segment_bounds(M, cache_segments)
    spans_even = all((hi - lo) % 2 == 0
                     for lo, hi in zip([0] + bounds[:-1], bounds))
    if megarow is None:
        megarow = use_pallas_gather and spans_even and deferred is not False
    if megarow:
        if deferred is False:
            raise ValueError("megarow=True implies the deferred path — "
                             "drop deferred=False")
        deferred = True
    if deferred is None:
        deferred = (use_pallas_gather or quant is not None) and spans_even
    if deferred and not spans_even:
        raise ValueError(
            f"deferred reorder needs even segment spans; M={M} with "
            f"cache_segments={cache_segments} gives bounds {bounds} — "
            "pick cache_segments so every span is even")
    if quant and not deferred:
        if spans_even:
            raise ValueError(
                f"kv_cache_quant={quant} requires the deferred decode path "
                "but deferred=False was passed explicitly — drop "
                "deferred=False (or the quant request)")
        raise ValueError(
            f"kv_cache_quant={quant} requires the deferred decode path, but "
            f"the segment spans for M={M}, cache_segments={cache_segments} "
            f"(bounds {bounds}) are not all even — adjust cache_segments")
    if kvg_quant_xla and not (quant == "int8" or (megarow and quant)):
        raise ValueError("kvg_quant_xla needs a quantized cache "
                         "(kv_cache_quant='int8'/'int4')")
    if ffn_int8:
        if not deferred:
            raise ValueError("ffn_int8 requires the deferred/megarow decode "
                             "path (the only paths that thread ffn_q)")
        if cfg.t5.is_gated:
            raise ValueError("ffn_int8 supports only the non-gated T5 v1.0 "
                             "FFN")
    # the deferred per-layer path with int8 rows quantized before the
    # gather (validated above: an int8 cache)
    kvg_q8 = bool(kvg_quant_xla) and not megarow
    # the reference's XLA path: slot t written before the attention
    write_attend = not deferred and not use_pallas_gather
    dev = resolve_device(device)

    def select(beam_scores, state, codes, logits, tables, t: int):
        """Trie mask + scored top-k + beam bookkeeping for one step."""
        B = beam_scores.shape[0]
        masked = logits
        if constrained:
            masked = torch.where(_trie_allowed(tables, state, t, K), logits,
                                 NEG_INF)
        cand = beam_scores[:, :, None] + masked               # [B, N, K]
        # keep dead beams dead (NEG_INF + logit could exceed NEG_INF)
        cand = torch.where(beam_scores[:, :, None] <= NEG_INF / 2, NEG_INF,
                           cand)
        # One full top-k over N*K. The reference's two-stage top-k picks
        # its branch from a device value (lax.cond); here that would be a
        # host sync per step, and the full top-k is the same function.
        new_scores, idx = torch.topk(cand.reshape(B, N * K), N, dim=1)
        src = idx // K                                        # [B, N]
        tok = idx % K
        if constrained:
            src_state = torch.gather(state, 1, src)
            child = _trie_child(tables, src_state, tok)
            new_state = torch.where(src_state >= 0, child, src_state)
            new_state = torch.where(new_scores <= NEG_INF / 2, -1, new_state)
        else:
            new_state = state
        codes = torch.gather(codes, 1, src[:, :, None].expand(-1, -1, M))
        codes[:, :, t] = tok
        return new_scores, new_state, tok, codes, src

    @torch.inference_mode()
    def run(model, input_ids, attention_mask, tables):
        if model.dtype != dtype:
            raise ValueError(f"model computes in {model.dtype}, this search "
                             f"was built for {dtype}")
        ids = torch.as_tensor(input_ids, device=dev)
        mask = torch.as_tensor(attention_mask, device=dev)
        B = ids.shape[0]
        enc = model.encode(ids, mask)
        cross_kv = model.decoder.precompute_cross_kv(enc)
        self_bias = model.decoder.full_self_bias(bounds[-1])
        enc_bias = torch.where(mask > 0, 0.0, NEG_INF).float()
        ctx = (cross_kv, enc_bias, self_bias)
        # once per call, outside the step loop
        ffn_q = quantize_ffn(model.state_dict(), L) if ffn_int8 else None

        beam_scores = torch.full((B, N), NEG_INF, device=dev)
        beam_scores[:, 0] = 0.0
        state = torch.zeros(B, N, dtype=torch.long, device=dev)
        tokens = torch.zeros(B, N, dtype=torch.long, device=dev)
        codes = torch.zeros(B, N, M, dtype=torch.long, device=dev)
        # the cache pair: ``cache`` holds the current beam order (for the
        # deferred paths: the previous step's), ``spare`` receives the
        # reorder; they swap every step
        dec = model.decoder
        if megarow:
            cache = dec.init_cache_megarow(B, N, bounds[0],
                                           quantized=quant or False)
        elif deferred:
            cache = dec.init_cache_merged(B, N, bounds[0],
                                          quantized=quant or False)
        else:
            cache = dec.init_cache(B, N, bounds[0])
        spare = torch.zeros_like(cache)
        slot_axis = cache.dim() - 2
        src_prev = torch.arange(N, dtype=torch.int32,
                                device=dev).expand(B, N).contiguous()
        # the deferred paths' pending rows of step t-1, in current beam
        # order: cache-layout rows on the megarow path (its QFUSE rows,
        # or exact rows) and with kvg_quant_xla, else exact K|V rows. The
        # t=0 placeholder is never read unmasked (megarow inserts it at
        # slot 0, rewritten at t=1; K4 inserts nothing at t=0); zeros keep
        # it finite.
        if megarow or kvg_q8:
            kvg = torch.zeros(B, N, L * cache.shape[-1], dtype=cache.dtype,
                              device=dev)
        else:
            kvg = torch.zeros(B, N, L * 2 * cfg.t5.inner_dim, dtype=dtype,
                              device=dev)
        lo = 0
        for s, hi in enumerate(bounds):
            for t in range(lo, hi):
                last = t + 1 == M          # the last step's rows are dead
                if megarow:
                    logits, spare, kv_new = model.decode_step_megarow(
                        tokens, cache, spare, src_prev, kvg, *ctx, t,
                        emit_quant=quant, ffn_q=ffn_q)
                    cache, spare = spare, cache
                elif deferred:
                    logits, spare, kv_new = model.decode_step_deferred(
                        tokens, cache, spare, src_prev, kvg, *ctx, t,
                        write_back=not last, ffn_q=ffn_q)
                    cache, spare = spare, cache
                elif write_attend:
                    logits, cache = model.decode_step_write_attend(
                        tokens, cache, *ctx, t)
                    kv_new = None
                else:
                    logits, kv_new = model.decode_step(tokens, cache, *ctx,
                                                       t)
                beam_scores, state, tokens, codes, src = select(
                    beam_scores, state, codes, logits, tables, t)
                src = src.to(torch.int32)
                if last:
                    continue
                if deferred:
                    src_prev = src
                    if kvg_q8:
                        kv_new = quantize_rows_plain(
                            kv_new.view(B, N, L, -1), H).view(B, N, -1)
                    kvg = beam_gather_rows(kv_new, src)
                else:
                    spare = _reorder_cache(cache, src, kv_new, t, spare)
                    cache, spare = spare, cache
            if s + 1 < len(bounds):
                # grow both buffers to the next segment's slot count
                del spare
                cache = _grow(cache, slot_axis, bounds[s + 1])
                spare = torch.zeros_like(cache)
            lo = hi
        return beam_scores, codes, state

    return run


def beam_search(cfg: RiporConfig, params, input_ids, attention_mask,
                trie=None, num_beams: int = 10, dtype=torch.bfloat16,
                device=None,
                use_pallas_gather: Optional[bool] = True) -> BeamSearchOutput:
    """Convenience wrapper: ``params`` is a state_dict (models/convert.py);
    builds the model and the search per call (hot paths should keep
    make_beam_search_fn's function and the model). ``use_pallas_gather``
    as in make_beam_search_fn (the reference's wrapper follows the
    backend: False on a CPU)."""
    from ripor_tpu_torch.models.ripor import RiporModel
    from ripor_tpu_torch.trie.succinct import (dummy_tables, succinct_tables,
                                               tables_to_torch)
    dev = resolve_device(device)
    constrained = trie is not None
    fn = make_beam_search_fn(cfg, num_beams, constrained=constrained,
                             dtype=dtype, use_pallas_gather=use_pallas_gather,
                             device=dev)
    model = RiporModel(cfg, dtype=dtype, device=dev)
    model.load_state_dict(params)
    tables = tables_to_torch(
        succinct_tables(trie) if constrained else dummy_tables(cfg.M), dev)
    scores, codes, state = fn(model, input_ids, attention_mask, tables)
    scores = scores.cpu().numpy()
    state = state.cpu().numpy()
    groups = np.where(state <= -2, -2 - state, -1).astype(np.int32)
    return BeamSearchOutput(scores=scores, codes=codes.cpu().numpy(),
                            groups=groups)


def expand_groups_to_docids(trie, groups: np.ndarray, scores: np.ndarray,
                            topk: int) -> Tuple[np.ndarray, np.ndarray]:
    """Expand one query's beam results (smtid groups) to ranked docids:
    every doc of a group inherits the beam score; truncated to topk.
    Returns (docids [<= topk], scores)."""
    out_docs, out_scores = [], []
    for g, s in zip(groups, scores):
        if g < 0 or s <= NEG_INF / 2:
            continue
        docs = trie.docids_of_group(int(g))
        out_docs.extend(docs.tolist())
        out_scores.extend([float(s)] * len(docs))
        if len(out_docs) >= topk:
            break
    return (np.asarray(out_docs[:topk], np.int32),
            np.asarray(out_scores[:topk], np.float32))
