"""Trie-constrained beam search on the megarow decode path, in PyTorch.

Port of ripor_tpu/decode/beam.py (``make_beam_search_fn`` with megarow=True
and, for quantized caches, QFUSE). Per step:

  K1 reorder (pending beam permutation + slot t-1 insert)
  -> per layer: projections, K2 step attention, cross-attention, FFN
  -> codebook-head logits -> trie mask -> scores + top-k
  -> K3 gather of this step's K|V rows into the new beam order

The pending reorder is carried as (src_prev, kvg): the next step's K1
completes it while copying the cache into the other buffer of a pair that
is swapped by reference each step. The whole loop issues no host sync
(no ``.item()``, no tensor in a Python condition), so on the card the
host runs ahead and the device never waits for it.

Score semantics match the reference: raw cumulative logits, no EOS, every
sequence runs all M steps, optional log-softmax in the model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.ops.beam_gather import beam_gather_rows

NEG_INF = -1e30

_LATER = ("is not ported to ripor_tpu_torch yet (a later slice of the port: "
          "ROADMAP.md Queue 1 item 5)")


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


def make_beam_search_fn(cfg: RiporConfig, num_beams: int,
                        constrained: bool = True,
                        max_steps: Optional[int] = None,
                        dtype=torch.bfloat16,
                        cache_segments: int = 4,
                        deferred: Optional[bool] = None,
                        kv_cache_int8: bool = False,
                        kv_cache_quant: Optional[str] = None,
                        kvg_quant_xla: Optional[bool] = None,
                        megarow: Optional[bool] = None,
                        ffn_int8: Optional[bool] = None,
                        device=None):
    """Build a beam-search function on the megarow decode path.

    Returns fn(model, input_ids, attention_mask, tables) -> (scores [B, N]
    float32, codes [B, N, M], states [B, N]) as tensors on ``device``.
    ``model`` is a RiporModel in ``dtype`` on ``device``; ``tables`` come
    from trie.tables_to_torch (for unconstrained search pass
    constrained=False and tables_to_torch(dummy_tables(M))).

    Arguments are validated as the reference validates them, so the same
    calls are accepted and refused. ``cache_segments``: the cache grows
    over that many equal step spans (M/S, 2M/S, ..., M slots), which cuts
    reorder and attention bytes; every span must be even (the reference's
    deferred-path rule). ``kv_cache_quant`` "int8"/"int4" (or
    kv_cache_int8=True) stores the cache quantized; K2 then emits each
    step's rows already quantized (QFUSE) — the only quantized dataflow
    ported, bit-identical to the others by the reference's own test.
    ``kvg_quant_xla`` selects a dataflow that QFUSE subsumes; it is
    validated and otherwise has no effect. ``deferred``/``megarow``: only
    the megarow path exists here; asking for another raises
    NotImplementedError, as does ``ffn_int8=True``.

    The reference's TPU knobs — use_pallas_gather, the RIPOR_* switches,
    chunk and layer-group picks, the ceil-8 slot rounding and the beam
    padding — have no counterpart: they served the TPU's tiling and VMEM.
    """
    M = max_steps or cfg.M
    N = num_beams
    K = cfg.K
    L = cfg.t5.num_decoder_layers
    if kv_cache_quant not in (None, "int8", "int4"):
        raise ValueError(f"kv_cache_quant must be int8/int4/None, "
                         f"got {kv_cache_quant!r}")
    quant = kv_cache_quant or ("int8" if kv_cache_int8 else None)
    bounds = _segment_bounds(M, cache_segments)
    spans_even = all((hi - lo) % 2 == 0
                     for lo, hi in zip([0] + bounds[:-1], bounds))
    if megarow is None:
        megarow = spans_even and deferred is not False
    if megarow:
        if deferred is False:
            raise ValueError("megarow=True implies the deferred path — "
                             "drop deferred=False")
        deferred = True
    if deferred is None:
        deferred = spans_even
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
    if kvg_quant_xla and not quant:
        raise ValueError("kvg_quant_xla needs a quantized cache "
                         "(kv_cache_quant='int8'/'int4')")
    if ffn_int8:
        raise NotImplementedError(f"ffn_int8 {_LATER}")
    if not megarow:
        raise NotImplementedError(
            f"the {'per-layer deferred' if deferred else 'XLA'} decode path "
            f"{_LATER}; only the megarow path is ported")
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

        beam_scores = torch.full((B, N), NEG_INF, device=dev)
        beam_scores[:, 0] = 0.0
        state = torch.zeros(B, N, dtype=torch.long, device=dev)
        tokens = torch.zeros(B, N, dtype=torch.long, device=dev)
        codes = torch.zeros(B, N, M, dtype=torch.long, device=dev)
        # the cache pair: ``cache`` holds the previous step's beam order,
        # ``spare`` receives the reorder; they swap every step
        cache = model.decoder.init_cache_megarow(B, N, bounds[0],
                                                 quantized=quant or False)
        spare = torch.zeros_like(cache)
        src_prev = torch.arange(N, dtype=torch.int32,
                                device=dev).expand(B, N).contiguous()
        # step t-1's rows in cache-row layout. The t=0 placeholder is
        # inserted at slot 0 and never read unmasked (slot 0 is rewritten
        # at t=1); zeros keep it finite.
        row_w = cache.shape[-1]
        kvg = torch.zeros(B, N, L * row_w, dtype=cache.dtype, device=dev)
        lo = 0
        for s, hi in enumerate(bounds):
            for t in range(lo, hi):
                logits, spare, kv_new = model.decode_step_megarow(
                    tokens, cache, spare, src_prev, kvg, cross_kv, enc_bias,
                    self_bias, t, emit_quant=quant)
                cache, spare = spare, cache
                beam_scores, state, tokens, codes, src = select(
                    beam_scores, state, codes, logits, tables, t)
                src_prev = src.to(torch.int32)
                if t + 1 < M:      # the last step's rows are never read
                    kvg = beam_gather_rows(kv_new, src_prev)
            if s + 1 < len(bounds):
                # grow both buffers to the next segment's slot count; new
                # slots are zero (see init_cache_megarow)
                del spare
                grown = cache.new_zeros(*cache.shape[:3], bounds[s + 1],
                                        row_w)
                grown[:, :, :, :bounds[s]] = cache
                cache = grown
                spare = torch.zeros_like(cache)
            lo = hi
        return beam_scores, codes, state

    return run


def beam_search(cfg: RiporConfig, params, input_ids, attention_mask,
                trie=None, num_beams: int = 10, dtype=torch.bfloat16,
                device=None) -> BeamSearchOutput:
    """Convenience wrapper: ``params`` is a state_dict (models/convert.py);
    builds the model and the search per call (hot paths should keep
    make_beam_search_fn's function and the model)."""
    from ripor_tpu_torch.models.ripor import RiporModel
    from ripor_tpu_torch.trie.succinct import (dummy_tables, succinct_tables,
                                               tables_to_torch)
    dev = resolve_device(device)
    constrained = trie is not None
    fn = make_beam_search_fn(cfg, num_beams, constrained=constrained,
                             dtype=dtype, device=dev)
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
