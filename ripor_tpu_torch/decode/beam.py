"""Trie-constrained beam search, in PyTorch.

Port of ripor_tpu/decode/beam.py (``make_beam_search_fn``) on its four
decode paths. Per step, after the projections of each layer:

  megarow (default when the segment spans are even):
    K1 reorder of all layers (pending beam permutation + slot t-1 insert)
    -> per layer K2 step attention (QFUSE: it also emits quantized rows;
    ``qfuse=False``: K1' quantizes exact rows on insert instead;
    ``fused_kvg``: K1'' gathers the rows itself; ``mxu_math``: K2')
  deferred per-layer (megarow=False):
    per layer K4: reorder of that layer + slot t-1 insert + attention
  non-deferred (deferred=False; the default when a span is odd):
    per layer K5 step attention over the stacked cache
  write-then-attend (use_pallas_gather=False, the reference's XLA path):
    per layer k/v written at slot t of the stacked cache, then K8

  -> cross-attention, FFN -> codebook-head logits -> trie mask -> top-k
  -> megarow, deferred: K3 gather of this step's K|V rows into the new
     beam order (none with fused_kvg); non-deferred: K3 + K6, the cache
     reorder with the slot t
     insert; write-then-attend: K7, the cache reorder (both every step
     but the last)

The two deferred paths carry the pending reorder as (src_prev, kvg): the
next step completes it while copying the cache into the other buffer of a
pair that is swapped by reference each step; the other two paths swap
their pair at each reorder. The whole loop issues no host sync (no
``.item()``, no tensor in a Python condition), so on the card the host
runs ahead. On the megarow path on the card the plain-torch work between
the kernels replays as CUDA graphs (make_beam_search_fn's docstring), so
the host's launches no longer set the pace of a search.

Score semantics match the reference: raw cumulative logits, no EOS, every
sequence runs all M steps, optional log-softmax in the model.

Over a ('data', 'model') mesh (core/mesh.py), make_sharded_beam_search_fn
splits the queries over 'data' and make_tp_beam_search_fn also splits
heads and d_ff over 'model'; both run one of the paths above on every
rank.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import types
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ripor_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, all_gather_cat,
                                       axis_size)
from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.ops.attend_reorder import (quantize_rows_int4_plain,
                                                quantize_rows_plain)
from ripor_tpu_torch.ops.beam_gather import (beam_gather_blocks,
                                             beam_gather_rows,
                                             beam_gather_update)
from ripor_tpu_torch.ops.int8_ffn import quantize_ffn

NEG_INF = -1e30

# The steps of make_beam_search_fn's searches: "captures" counts searches
# that captured a new shape's CUDA graphs, "graphed_steps" the steps run
# through the graphs, "eager_steps" the steps of the eager loop
DECODE_STEPS: Dict[str, int] = {"captures": 0, "graphed_steps": 0,
                                "eager_steps": 0}
# graph sets one search function keeps (a set per batch size, model and
# trie); beyond it the least recently used goes
GRAPH_SETS = 6


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


class _Pieces:
    """The CUDA graphs of one search shape: each chain of plain-torch work
    between two hand-written kernels is captured on its first call and
    replayed after, on the caller's stream. The captures run on a side
    stream, after one eager pass of the pieces there (``warm``: cuBLAS sets
    up its workspace for that stream outside a capture), into one memory
    pool that the pieces share, since they replay one after another on one
    stream. Without ``capture`` each call runs its piece."""

    def __init__(self, device, capture: bool):
        self.capture = capture
        self.graphs = {}
        if capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.side = torch.cuda.Stream(device)
            self.done = torch.cuda.Event()

    def warm(self, fn):
        if not self.capture:
            return
        cur = torch.cuda.current_stream()
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            fn()
        cur.wait_stream(self.side)

    def __call__(self, name, fn, *args):
        if not self.capture:
            fn(*args)
            return
        g = self.graphs.get(name)
        if g is None:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.side):
                # thread_local: another thread (the serving engine's
                # completer) may copy results while this one captures
                g.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
                try:
                    fn(*args)
                finally:
                    g.capture_end()
            self.graphs[name] = g
        g.replay()

    def begin(self):
        """Order this search after the last one on these buffers, which
        another stream may have run."""
        if self.capture:
            torch.cuda.current_stream().wait_event(self.done)

    def end(self):
        if self.capture:
            self.done.record()

    def drop(self):
        """Wait for the device before these graphs and their pool go."""
        if self.capture:
            torch.cuda.synchronize(self.side.device)


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
                        qfuse: bool = True,
                        fused_kvg: bool = False,
                        mxu_math: bool = False,
                        device=None, _graphs: Optional[bool] = None):
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
    needs a deferred path. On the deferred path K4 quantizes step t-1's
    exact rows as it inserts them, unless ``kvg_quant_xla`` (int8 caches
    only) quantizes them once per step before the gather.

    The megarow path's kvg dataflow follows the reference's
    (beam.py:300-338, :478-506), with its switches as arguments:
    ``qfuse`` (RIPOR_MR_QFUSE, default True): on a quantized cache K2
    emits each step's rows already quantized, K3 gathers them and K1
    inserts them verbatim; ``qfuse=False``: K3 gathers the exact rows and
    K1' quantizes them on insert, or with ``kvg_quant_xla``
    (RIPOR_MR_KVG_XLA) plain torch quantizes them once a step before K3
    and K1 inserts them verbatim. ``fused_kvg`` (RIPOR_MR_FUSED_KVG):
    the rows stay un-permuted and K1'' gathers them by src, so no K3
    runs. ``mxu_math`` (RIPOR_MR_MXU): K2' on a quantized cache. The
    searches are bit-identical whatever ``qfuse``, ``fused_kvg`` and
    ``kvg_quant_xla``; ``mxu_math`` rounds the p*v products otherwise
    (held at the reference's gates). As in the reference, ``qfuse`` and
    ``mxu_math`` have no effect on an exact cache (where ``kvg_quant_xla``
    is refused), and the three switches none off the megarow path.

    ``ffn_int8=True`` runs the decode-step FFN with per-channel int8
    weights (quantized once per call) and per-row int8 activations
    (ops/int8_ffn.py), on the megarow and deferred paths and for the
    non-gated FFN only, as the reference (its ValueErrors otherwise);
    None means off.

    The reference's other TPU knobs — the other RIPOR_* switches, chunk
    and layer-group picks, the ceil-8 slot rounding and the beam padding
    — have no counterpart: they served the TPU's tiling and VMEM. Where the
    reference's default for use_pallas_gather follows the backend, the
    port's is True everywhere, so a call without it keeps its kernel
    path.

    The megarow search runs its step in pieces (Decoder.megarow_*): the
    plain-torch chains between the hand-written kernels, K1, K2 and K3
    launched between them through their usual entries, so their launch
    counters and wrappers see every call. The pieces are a prologue
    (encoder, cross-attention K/V, the biases, the int8 FFN weights, the
    beams' start), a head a step (position input, layer 0's projections),
    one piece a layer boundary (the rest of layer l, layer l+1's
    projections), and three a step after the last layer: its tail (the
    rest of the last layer), the logits (the final norm and the head over
    the codebook, into a static float32 [B, N, K] buffer) and ``select``
    (the trie mask, the top-k and the beams' bookkeeping), the last two
    inside ``torch.profiler.record_function`` spans ``codebook_head`` and
    ``select``. On a CUDA device outside tensor parallelism
    (``cfg.t5.tp_axis`` None: its layers all-reduce) they replay as CUDA
    graphs, so the host issues ~30 actions a step instead of ~765
    launches; elsewhere (the CPU, TP) they run as they are. The graphs of
    a batch size are captured on its first search, for that model's
    parameters and those trie tables (another model or trie, or the same
    tensors moved, captures anew; a model with a patched or hooked
    module's forward runs its pieces uncaptured); the search that
    captures takes about as long on the host as an uncaptured one, and a
    capture that fails raises. A function keeps GRAPH_SETS such sets,
    least recently used out, and refers to the model and the tables only
    weakly: a set of a freed model or tables goes at the next search. A
    set holds static buffers of about B*N*(10*d_model + L*w + 8*M + 4*K)
    bytes at 16-bit activations (the hidden state, q, K|V, the attention,
    this step's rows of every layer, w bytes each, and the logits), and a
    memory pool with the cross-attention K/V and its pieces' temporaries:
    at t5-base on an H100, 297 MB in all at B=8, N=1000, K=256 with the
    int4 cache, and 42 MB to 1,029 MB at N=100 with the exact bf16 cache
    from B=1 to B=64, before the logits buffer (8.2 MB more at B=8,
    N=1000, K=256). Searches return fresh tensors, so two may be in
    flight.
    ``DECODE_STEPS`` counts captures and graphed and eager steps.
    ``_graphs`` (tests): False never keeps a set, True keeps them on any
    device (captured on a card only).
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
    # the megarow kvg dataflow: QFUSE (K2 emits cache rows), or plain
    # torch quantizing before the gather (kvg_quant_xla without QFUSE),
    # or exact rows that K1' quantizes on insert; fused: K1'' gathers
    mr_qfuse = megarow and qfuse and quant is not None
    mr_quant_xla = (megarow and quant is not None and not mr_qfuse
                    and bool(kvg_quant_xla))
    mr_fused = megarow and fused_kvg
    mr_mxu = megarow and mxu_math
    quantize_plain = (quantize_rows_int4_plain if quant == "int4"
                      else quantize_rows_plain)
    # the reference's XLA path: slot t written before the attention
    write_attend = not deferred and not use_pallas_gather
    dev = resolve_device(device)
    if _graphs is None:
        _graphs = (megarow and dev.type == "cuda"
                   and cfg.t5.tp_axis is None)
    elif _graphs and not megarow:
        raise ValueError("graph sets are of the megarow path only")

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

    def first_rows(B, rw, cache_dtype):
        """The t=0 placeholder of the deferred paths' pending rows of step
        t-1 (kvg), in current beam order (un-permuted with fused_kvg):
        cache-layout rows of ``rw`` on the megarow path with an exact
        cache, QFUSE or kvg_quant_xla, and on the deferred path with
        kvg_quant_xla, else exact K|V rows. It is never read unmasked
        (megarow inserts it at slot 0, rewritten at t=1; K4 inserts
        nothing at t=0); zeros keep it finite."""
        if (megarow and (quant is None or mr_qfuse or mr_quant_xla)
                or kvg_q8):
            return torch.zeros(B, N, L * rw, dtype=cache_dtype, device=dev)
        return torch.zeros(B, N, L * 2 * cfg.t5.inner_dim, dtype=dtype,
                           device=dev)

    # the kept graph sets (graph_set), by graph_key
    graph_sets: "collections.OrderedDict" = collections.OrderedDict()
    graph_lock = threading.Lock()

    @torch.inference_mode()
    def run(model, input_ids, attention_mask, tables):
        if model.dtype != dtype:
            raise ValueError(f"model computes in {model.dtype}, this search "
                             f"was built for {dtype}")
        ids = torch.as_tensor(input_ids, device=dev)
        mask = torch.as_tensor(attention_mask, device=dev)
        if megarow:
            return run_megarow(model, ids, mask, tables)
        return run_eager(model, ids, mask, tables)

    def run_eager(model, ids, mask, tables):
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
        # deferred path: the previous step's), ``spare`` receives the
        # reorder; they swap every step
        dec = model.decoder
        if deferred:
            cache = dec.init_cache_merged(B, N, bounds[0],
                                          quantized=quant or False)
        else:
            cache = dec.init_cache(B, N, bounds[0])
        spare = torch.zeros_like(cache)
        slot_axis = cache.dim() - 2
        src_prev = torch.arange(N, dtype=torch.int32,
                                device=dev).expand(B, N).contiguous()
        kvg = first_rows(B, cache.shape[-1], cache.dtype)
        lo = 0
        for s, hi in enumerate(bounds):
            for t in range(lo, hi):
                DECODE_STEPS["eager_steps"] += 1
                last = t + 1 == M          # the last step's rows are dead
                if deferred:
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
                        kv_new = quantize_plain(
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

    def run_megarow(model, ids, mask, tables):
        """The megarow search through a graph set: a kept one where graphs
        engage (captured on a card), else one made for this call."""
        key = graph_key(model, ids, mask, tables) if _graphs else None
        if key is None:
            return search(graph_set(model, tables, ids, mask, kept=False),
                          model, tables, ids, mask)
        with graph_lock:
            for k in [k for k, e in graph_sets.items()
                      if not holds(e, model, tables, k == key)]:
                graph_sets.pop(k).pieces.drop()
            e = graph_sets.get(key)
            if e is None:
                e = graph_set(model, tables, ids, mask, kept=True)
                DECODE_STEPS["captures"] += 1
                graph_sets[key] = e
                while len(graph_sets) > GRAPH_SETS:
                    graph_sets.popitem(last=False)[1].pieces.drop()
            else:
                graph_sets.move_to_end(key)
            try:
                return search(e, model, tables, ids, mask)
            except BaseException:
                del graph_sets[key]
                raise

    def graph_key(model, ids, mask, tables):
        """A graph set's key: the shapes, and the addresses and shapes of
        the model's parameters and buffers and of the trie tables, which
        its graphs read. None for a model with a module whose forward is
        patched or hooked (as parallel/reference.py::split_sums patches
        them): graphs hold the code that ran when they were captured."""
        ptrs = []
        for m in model.modules():
            if ("forward" in vars(m) or m._forward_hooks
                    or m._forward_pre_hooks):
                return None
            ptrs.extend((x.data_ptr(), x.shape)
                        for x in (*m._parameters.values(),
                                  *m._buffers.values()) if x is not None)
        return (tuple(ids.shape), ids.dtype, mask.dtype, tuple(ptrs),
                tuple((x.data_ptr(), x.shape) for x in tables))

    def holds(e, model, tables, this: bool):
        """Whether kept set e may stay: its model and tables are alive,
        and, for this search's key, are this model and these tables (not
        others that came to the same addresses)."""
        refs = (e.model, *e.tables)
        if this:
            return all(r() is x for r, x in zip(refs, (model, *tables)))
        return all(r() is not None for r in refs)

    def graph_set(model, tables, ids, mask, kept: bool):
        """A shape's static buffers and its pieces (a namespace that
        refers to the model and the tables only weakly); a kept set's
        pieces are warmed here and captured by its first search on a
        card."""
        dec = model.decoder
        B, S = ids.shape
        d, F = cfg.t5.d_model, cfg.t5.inner_dim
        rw, cdt = dec._cache_rows(quant or False)

        def zeros(*shape, dt=dtype):
            return torch.zeros(*shape, dtype=dt, device=dev)

        e = types.SimpleNamespace()
        e.model = weakref.ref(model)
        e.tables = [weakref.ref(x) for x in tables]
        e.steps = "graphed_steps" if kept else "eager_steps"
        e.ids, e.mask = zeros(B, S, dt=ids.dtype), zeros(B, S, dt=mask.dtype)
        e.scores, e.codes = zeros(B, N, dt=torch.float32), zeros(
            B, N, M, dt=torch.long)
        e.state, e.tokens = (zeros(B, N, dt=torch.long) for _ in range(2))
        e.src = zeros(B, N, dt=torch.int32)
        e.src0 = torch.arange(N, dtype=torch.int32,
                              device=dev).expand(B, N).contiguous()
        e.x = zeros(B, N, d)
        e.logits = zeros(B, N, K, dt=torch.float32)
        e.q, e.attn = zeros(B, N, F), zeros(B, N, F)
        e.kvf = zeros(B, N, 2 * F)
        # K2's outputs, which the next piece reads
        e.kvq = zeros(B, N, rw, dt=cdt) if mr_qfuse else None
        e.k2_out = (e.attn, e.kvq) if mr_qfuse else e.attn
        # this step's rows of every layer, stacked
        e.kv_new = (zeros(B, N, L, rw, dt=cdt) if mr_qfuse
                    else zeros(B, N, L, 2 * F))
        e.kv_quant = zeros(B, N, L * rw, dt=cdt) if mr_quant_xla else None
        e.kvg0 = first_rows(B, rw, cdt)
        e.pieces = _Pieces(dev, capture=kept and dev.type == "cuda")

        def warm():
            prologue(e, model)
            head(e, model, 0)
            for l in range(L - 1):
                boundary(e, model, l)
            tail(e, model, 0)
            step_logits(e, model, 0)
            step_select(e, tables, 0)

        e.pieces.warm(warm)
        return e

    # The pieces of the megarow search. They read and write set e's
    # buffers and take the model and the tables as arguments, so that a
    # kept set holds neither.

    def prologue(e, model):
        dec = model.decoder
        enc = model.encode(e.ids, e.mask)
        e.cross_kv = dec.precompute_cross_kv(enc)
        e.enc_bias = torch.where(e.mask > 0, 0.0, NEG_INF).float()
        e.hist, e.new = dec.step_bias_tables(dec.full_self_bias(bounds[-1]))
        e.ffn_q = quantize_ffn(model.state_dict(), L) if ffn_int8 else None
        e.scores.fill_(NEG_INF)
        e.scores[:, 0] = 0.0
        e.state.zero_()
        e.tokens.zero_()
        e.codes.zero_()

    def project(e, model, l, x):
        q, _ = model.decoder.megarow_qkv(l, x, out=e.kvf)
        e.q.copy_(q)

    def finish(e, model, l):
        e.kv_new[:, :, l].copy_(e.kvq if mr_qfuse else e.kvf)
        return model.decoder.megarow_finish(l, e.x, e.attn, e.cross_kv,
                                            e.enc_bias, e.ffn_q)

    def head(e, model, t):
        x = model._step_input(e.tokens, t)
        e.x.copy_(x)
        project(e, model, 0, x)

    def boundary(e, model, l):
        x = finish(e, model, l)
        e.x.copy_(x)
        project(e, model, l + 1, x)

    def tail(e, model, t):
        e.x.copy_(finish(e, model, L - 1))
        if mr_quant_xla and t + 1 < M:
            e.kv_quant.copy_(quantize_plain(e.kv_new, H).view(
                e.kv_quant.shape))

    def step_logits(e, model, t):
        model._step_logits(model.decoder.final_norm(e.x), t, out=e.logits)

    def step_select(e, tables, t):
        scores, state, tok, codes, src = select(e.scores, e.state, e.codes,
                                                e.logits, tables, t)
        e.scores.copy_(scores)
        e.state.copy_(state)
        e.tokens.copy_(tok)
        e.codes.copy_(codes)
        e.src.copy_(src)

    def search(e, model, tables, ids, mask):
        """The megarow search through set e's pieces, with K1 (the pending
        beam reorder and the slot t-1 insert), K2 (each layer's attention
        over the reordered cache) and K3 (the gather of step t-1's rows,
        unless K1 gathers them: fused_kvg) launched eagerly between
        them."""
        dec = model.decoder
        B = ids.shape[0]
        piece = e.pieces
        piece.begin()
        e.ids.copy_(ids)
        e.mask.copy_(mask)
        piece("prologue", prologue, e, model)
        # the cache pair: ``cache`` holds the previous step's beam order,
        # K1 reorders it into ``spare``; they swap every step
        cache = dec.init_cache_megarow(B, N, bounds[0],
                                       quantized=quant or False)
        spare = torch.zeros_like(cache)
        src_prev, kvg = e.src0, e.kvg0
        lo = 0
        for s, hi in enumerate(bounds):
            for t in range(lo, hi):
                piece(("head", t), head, e, model, t)
                dec.megarow_reorder(kvg, cache, spare, src_prev, t, mr_fused)
                for l in range(L):
                    dec.megarow_attend(e.q, e.kvf, spare, l,
                                       e.hist[t, :spare.shape[3]], e.new[t],
                                       quant if mr_qfuse else None, mr_mxu,
                                       out=e.k2_out)
                    if l + 1 < L:
                        piece(("boundary", l), boundary, e, model, l)
                piece(("tail", t), tail, e, model, t)
                with torch.profiler.record_function("codebook_head"):
                    piece(("logits", t), step_logits, e, model, t)
                with torch.profiler.record_function("select"):
                    piece(("select", t), step_select, e, tables, t)
                cache, spare = spare, cache
                DECODE_STEPS[e.steps] += 1
                if t + 1 == M:          # the last step's rows are dead
                    continue
                src_prev = e.src
                rows = (e.kv_quant if mr_quant_xla
                        else e.kv_new.view(B, N, -1))
                kvg = rows if mr_fused else beam_gather_rows(rows, e.src)
            if s + 1 < len(bounds):
                # grow both buffers to the next segment's slot count
                del spare
                cache = _grow(cache, cache.dim() - 2, bounds[s + 1])
                spare = torch.zeros_like(cache)
            lo = hi
        out = e.scores.clone(), e.codes.clone(), e.state.clone()
        piece.end()
        return out

    run.graphed = bool(_graphs)
    return run


def _data_parallel(inner, mesh):
    """``inner`` run SPMD over the mesh's 'data' axis: each rank searches
    its slice of the query batch, and the slices' scores, codes and states
    are gathered over the data group, so every rank returns the whole
    batch's."""
    ndata = axis_size(mesh, DATA_AXIS)
    i = mesh.get_local_rank(DATA_AXIS)
    group = mesh.get_group(DATA_AXIS)

    @torch.inference_mode()
    def run(model, input_ids, attention_mask, tables):
        B = input_ids.shape[0]
        if B % ndata != 0:
            raise ValueError(
                f"query batch {B} must divide the 'data' "
                f"axis ({ndata}); pad ragged batches with "
                f"pad_batch_to_data_axis() and drop the padded results")
        n = B // ndata
        out = inner(model, input_ids[i * n:(i + 1) * n],
                    attention_mask[i * n:(i + 1) * n], tables)
        return tuple(all_gather_cat(x, group) for x in out)

    return run


def make_sharded_beam_search_fn(cfg: RiporConfig, num_beams: int, mesh,
                                **kw):
    """Data-parallel constrained beam search: queries split over the
    mesh's 'data' axis, the model and trie tables are whole on every rank,
    and each rank runs the full decode on its queries (replaces the
    reference's one-query-per-GPU DDP inference, evaluate.py:457-487).

    SPMD: every rank calls the returned fn(model, input_ids,
    attention_mask, tables) with the same global batch, which must divide
    the data axis, and gets the global (scores, codes, states) back.
    Keyword arguments as make_beam_search_fn's."""
    return _data_parallel(make_beam_search_fn(cfg, num_beams, **kw), mesh)


def pad_batch_to_data_axis(input_ids, attention_mask, mesh):
    """Pad a ragged query batch up to a multiple of the mesh 'data' axis by
    repeating the final query row (repeats keep every rank's compute
    well-formed — a zero-mask dummy would attend over nothing). Returns
    ``(input_ids, attention_mask, n_valid)``; callers slice every output's
    leading axis to ``n_valid`` (the reference pads the same way via its
    DistributedSampler's wrap-around, evaluate.py:468). Numpy arrays or
    tensors."""
    n = input_ids.shape[0]
    pad = (-n) % axis_size(mesh, DATA_AXIS)
    if pad:
        cat = torch.cat if isinstance(input_ids, torch.Tensor) \
            else np.concatenate
        input_ids = cat([input_ids] + [input_ids[-1:]] * pad)
        attention_mask = cat([attention_mask] + [attention_mask[-1:]] * pad)
    return input_ids, attention_mask, n


def make_tp_beam_search_fn(cfg: RiporConfig, num_beams: int, mesh,
                           dtype=torch.bfloat16, device=None, **kw):
    """Tensor-parallel (optionally x data-parallel) constrained beam search.

    Attention heads, d_ff and the KV cache split over the mesh's 'model'
    axis megatron-style (each rank's cache keeps the merged-head row
    layout with H/mp heads, so the row width RW halves for each 2-way
    split; the int8/int4 quantization groups are per head, so a shard is
    self-contained); queries split over 'data'. The attention and FFN
    output projections all-reduce over the model group in every layer
    (models/layers.py). Beam selection and the trie mask run replicated
    within a model group: the all-reduced activations are the same on
    each of its ranks, so the picks are too.

    SPMD: every rank calls the returned fn(params, input_ids,
    attention_mask, tables) with the same global inputs; ``params`` is the
    UNSHARDED model (a RiporModel or its state_dict), from which the rank's
    per-rank model is built by parallel/sharding.py::shard_decode_params.
    That model is kept for the next call while ``params`` holds the same
    tensors, unchanged in place (their version counters); other params
    build it anew. num_heads and d_ff must divide the 'model' axis size.
    Other keyword arguments as make_beam_search_fn's.
    """
    from ripor_tpu_torch.models.ripor import RiporModel
    from ripor_tpu_torch.parallel.sharding import shard_decode_params

    dev = resolve_device(device)
    mp = axis_size(mesh, MODEL_AXIS)
    t5 = cfg.t5
    if t5.num_heads % mp or t5.d_ff % mp:
        raise ValueError(f"num_heads={t5.num_heads} and d_ff={t5.d_ff} must "
                         f"divide the model axis ({mp})")
    cfg_local = dataclasses.replace(
        cfg, t5=dataclasses.replace(t5, num_heads=t5.num_heads // mp,
                                    d_ff=t5.d_ff // mp, tp_axis=MODEL_AXIS))
    search = _data_parallel(make_beam_search_fn(
        cfg_local, num_beams, dtype=dtype, device=dev, **kw), mesh)
    group = mesh.get_group(MODEL_AXIS)
    built = {}                # "key": the params' tensors and versions

    def local_model(params):
        sd = (params.state_dict(keep_vars=True)
              if isinstance(params, torch.nn.Module) else params)
        # inference tensors keep no version counter: never reused
        key = (None if any(t.is_inference() for t in sd.values())
               else [(t, t._version) for t in sd.values()])
        old = built.get("key")
        if key is None or old is None or len(old) != len(key) or any(
                a is not b or u != v for (a, u), (b, v) in zip(old, key)):
            built.clear()
            local = RiporModel(cfg_local, dtype=dtype, device=dev)
            local.load_state_dict(shard_decode_params(
                {k: t.detach() for k, t in sd.items()}, mesh))
            built.update(key=key, model=local.set_tp_group(group))
        return built["model"]

    def run(params, input_ids, attention_mask, tables):
        return search(local_model(params), input_ids, attention_mask, tables)

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
