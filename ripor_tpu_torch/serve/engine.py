"""Microbatching retrieval engine over the megarow beam search, in PyTorch.

Port of ripor_tpu/serve/engine.py (``ServeConfig``, ``BaseEngine``,
``RetrievalEngine``). The engine pads every microbatch to a rung of a
small ladder of batch sizes, and coalesces concurrent requests into one
device call: a batcher thread drains the request queue, waits at most
``max_delay_ms`` for co-riders, then dispatches.

``retrieve_batch`` is the synchronous path; ``submit`` returns a Future.
The decode is asynchronous on the card (the beam loop issues no host
sync), so the batcher dispatches batch N+1 while a completion thread
waits for batch N's results and expands them to docids.
"""
from __future__ import annotations

import logging
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ServeConfig:
    """Engine knobs. ``batch_sizes`` is the warm-shape ladder (ascending);
    the largest entry is also the microbatch cap."""
    num_beams: int = 100
    topk: int = 100
    max_length: int = 64
    batch_sizes: Tuple[int, ...] = (1, 4, 8)
    kv_cache_quant: Optional[str] = None
    # int8-weight FFN (ops/int8_ffn.py); None means off (the port reads no
    # RIPOR_FFN_INT8). The engine preflights decode.quant_gate: an ffn_int8
    # combination must carry a recorded validation in ckpt_dir, or the
    # engine refuses to start.
    ffn_int8: Optional[bool] = None
    # checkpoint dir whose quant_validation.json vouches for the combo
    ckpt_dir: Optional[str] = None
    constrained: bool = True
    max_delay_ms: float = 5.0
    stats_window: int = 10_000          # latency samples kept for percentiles
    # opt-in device tracing via GET /profile (serve/http.py). Off by
    # default: the endpoint occupies a handler thread for the capture
    # window and writes to local disk, so it must be an operator decision,
    # not a client capability. Traces always land under profile_dir (the
    # client cannot choose the path); the reference's /tmp/ripor_trace,
    # under TMPDIR where that is set.
    enable_profile: bool = False
    profile_dir: str = os.path.join(tempfile.gettempdir(), "ripor_trace")
    # how long stop() waits for the in-flight device batch before logging
    # that the batcher is wedged
    stop_join_timeout_s: float = 300.0
    # dtype the checkpoint params are rounded to before they are loaded
    # into the bf16 decode model ("bfloat16": what the decode computes in
    # anyway). None keeps them as given; only the float32 RMSNorm scales
    # then keep more precision.
    param_dtype: Optional[str] = "bfloat16"


@dataclass
class _Request:
    text: str
    future: Future
    t_submit: float = field(default_factory=time.monotonic)


class BaseEngine:
    """Warm-shape microbatching over an abstract per-batch device call.

    Subclasses implement ``_dispatch(texts) -> handle`` (host prep + an
    asynchronous device launch that must not wait for device results) and
    ``_finish(handle, n) -> results`` (wait for the device + host
    post-processing). ``_decode`` = dispatch + finish is the synchronous
    path (warmup, retrieve_batch).

    The async batcher pipelines the two: while the device executes batch
    N, the batcher thread collects, tokenizes and dispatches batch N+1 and
    a completion thread finishes batch N. In-flight depth is bounded at 2
    so queueing latency stays one device batch.
    """

    def __init__(self, serve_cfg: ServeConfig, warm: bool = True):
        self.scfg = serve_cfg
        self._sizes = tuple(sorted(set(serve_cfg.batch_sizes)))
        if not self._sizes:
            raise ValueError("batch_sizes must be non-empty")
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._lock = threading.Lock()
        self._lat: List[float] = []          # seconds, submit -> done
        self._batch_hist: Dict[int, int] = {}
        self._served = 0
        self._t_start = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        # (batch, rung, handle) triples in flight on the device; maxsize
        # bounds dispatch-ahead so a slow device call backpressures the
        # batcher instead of growing an unbounded device queue
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        # dispatched-but-unfinished count (the completer pops an item
        # before finishing it, so the queue above cannot serve as this
        # signal); the batcher coalesces past max_delay_ms while it is > 0
        self._inflight_n = 0
        if warm:
            self.warmup()

    def _dispatch(self, texts: Sequence[str]) -> object:
        """Host prep + async device dispatch for one warm-shape batch.
        MUST NOT block on device results."""
        raise NotImplementedError

    def _finish(self, handle: object, n: int) -> List[object]:
        """Wait for the device results of ``_dispatch`` and post-process;
        returns one result per input row."""
        raise NotImplementedError

    def _decode(self, texts: Sequence[str]) -> List[object]:
        """Synchronous decode (warmup / retrieve_batch): dispatch+finish."""
        return self._finish(self._dispatch(texts), len(texts))

    # -- synchronous path ---------------------------------------------------

    def warmup(self):
        """One decode per ladder rung (on the card this also builds the
        kernels and warms the allocator for every shape)."""
        for b in self._sizes:
            self._decode([""] * b)

    def retrieve_batch(self, texts: Sequence[str]
                       ) -> List[List[Tuple[str, float]]]:
        """Synchronous retrieval: pads to the nearest warm shape (splitting
        into max-size chunks if the request exceeds the ladder)."""
        t0 = time.monotonic()
        cap = self._sizes[-1]
        out: List[List[Tuple[str, float]]] = []
        for s in range(0, len(texts), cap):
            part = list(texts[s:s + cap])
            rung = next(b for b in self._sizes if b >= len(part))
            res = self._decode(part + [""] * (rung - len(part)))
            out.extend(res[:len(part)])
            self._record(rung, len(part), t0)
        return out

    # -- async microbatching path -------------------------------------------

    def start(self):
        """Start the batcher + completion threads (idempotent; restartable
        after stop())."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            # fresh in-flight queue: after a clean stop it may hold a stale
            # None sentinel, which would end the new completer at once
            self._inflight = queue.Queue(maxsize=2)
            self._inflight_n = 0
            self._thread = threading.Thread(target=self._batch_loop,
                                            name="ripor-batcher", daemon=True)
            self._completer = threading.Thread(target=self._complete_loop,
                                               name="ripor-completer",
                                               daemon=True)
            self._thread.start()
            self._completer.start()

    def stop(self):
        """Stop the batcher and FAIL any still-queued requests (a future
        that never resolves deadlocks its client). Waits for the batcher to
        exit, then for the completion thread to drain every in-flight
        batch, before draining the queue."""
        self._stop.set()
        timeout = self.scfg.stop_join_timeout_s
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            wedged = self._thread.is_alive()
        if (self._completer is not None and self._completer.is_alive()
                and not wedged):
            # batcher exited -> no new dispatches; the sentinel ends the
            # completer after it finishes the in-flight batches
            self._inflight.put(None)
            self._completer.join(timeout=timeout)
            wedged = self._completer.is_alive()
        if wedged:
            logging.getLogger(__name__).error(
                "batcher/completer did not exit within %.0fs; a device call "
                "is likely wedged — queued requests will be failed but "
                "in-flight batches may still complete", timeout)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("engine stopped before request was served"))

    def submit(self, text: str) -> Future:
        """Enqueue one query; the Future resolves to its top-k list.
        Requires start(); concurrent submitters share device batches."""
        req = _Request(text, Future())
        self._q.put(req)
        return req.future

    def _batch_loop(self):
        """Collect + tokenize + dispatch batches; never waits for device
        results. Coalescing is load-aware: ``max_delay_ms`` bounds the added
        latency only while the device is idle; while a batch is in flight,
        collection goes on until the rung is full (an early partial
        dispatch could not start any sooner)."""
        cap = self._sizes[-1]
        delay = self.scfg.max_delay_ms / 1e3
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + delay
            while len(batch) < cap:
                left = deadline - time.monotonic()
                if left <= 0 and (self._inflight_n == 0
                                  or self._stop.is_set()):
                    break
                try:
                    batch.append(self._q.get(
                        timeout=min(max(left, 0.002), 0.05)))
                except queue.Empty:
                    pass
            rung = next(b for b in self._sizes if b >= len(batch))
            try:
                handle = self._dispatch([r.text for r in batch]
                                        + [""] * (rung - len(batch)))
            except Exception as e:      # surface device errors per request
                for r in batch:
                    r.future.set_exception(e)
                continue
            with self._lock:
                self._inflight_n += 1
            self._inflight.put((batch, rung, handle))

    def _complete_loop(self):
        """Finish dispatched batches in dispatch order."""
        while True:
            item = self._inflight.get()
            if item is None:            # stop() sentinel after batcher exit
                return
            batch, rung, handle = item
            try:
                res = self._finish(handle, len(batch))
            except Exception as e:
                for r in batch:
                    r.future.set_exception(e)
                with self._lock:
                    self._inflight_n -= 1
                continue
            now = time.monotonic()
            with self._lock:
                self._inflight_n -= 1
                self._batch_hist[rung] = self._batch_hist.get(rung, 0) + 1
                self._served += len(batch)
                for r in batch:
                    self._lat.append(now - r.t_submit)
                del self._lat[:-self.scfg.stats_window]
            for r, item_res in zip(batch, res):
                r.future.set_result(item_res)

    # -- observability -------------------------------------------------------

    def _record(self, rung: int, n: int, t0: float):
        now = time.monotonic()
        with self._lock:
            self._batch_hist[rung] = self._batch_hist.get(rung, 0) + 1
            self._served += n
            self._lat.extend([now - t0] * n)
            del self._lat[:-self.scfg.stats_window]

    def stats(self) -> Dict[str, object]:
        """Serving stats: latency percentiles (seconds, over the last
        ``stats_window`` requests), lifetime qps, batch-size histogram."""
        with self._lock:
            lat = sorted(self._lat)
            hist = dict(self._batch_hist)
            served = self._served
        elapsed = max(time.monotonic() - self._t_start, 1e-9)

        def pct(p):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]

        return {"served": served, "qps": served / elapsed,
                "p50_s": pct(50), "p90_s": pct(90), "p99_s": pct(99),
                "batch_hist": hist, "queue_depth": self._q.qsize()}


class RetrievalEngine(BaseEngine):
    """Query text -> top-k (docid, score) over the constrained-beam decoder.

    ``params`` is a state_dict (models/convert.py). The decode runs in
    bfloat16 on ``device`` ("cuda" unless the caller passes another; no
    CUDA raises RuntimeError)."""

    def __init__(self, cfg, params, tok, trie, docids: Sequence[str],
                 serve_cfg: ServeConfig = ServeConfig(), warm: bool = True,
                 mesh=None, device=None):
        import torch

        from ripor_tpu_torch.decode.beam import (make_beam_search_fn,
                                                 resolve_device)
        from ripor_tpu_torch.decode.quant_gate import ensure_quant_validated
        from ripor_tpu_torch.models.ripor import RiporModel
        from ripor_tpu_torch.trie.succinct import (succinct_tables,
                                                   tables_to_torch)

        if mesh is not None:
            raise NotImplementedError(
                "data-parallel serving over a mesh is not ported to "
                "ripor_tpu_torch yet (a later slice of the port: ROADMAP.md "
                "Queue 1 item 5)")
        ensure_quant_validated(serve_cfg.kv_cache_quant,
                               bool(serve_cfg.ffn_int8),
                               ckpt_dir=serve_cfg.ckpt_dir)
        self._device = resolve_device(device)
        self.cfg = cfg
        self._tok = tok
        self._trie = trie
        self._docids = list(docids)
        self._fn = make_beam_search_fn(
            cfg, serve_cfg.num_beams, constrained=serve_cfg.constrained,
            kv_cache_quant=serve_cfg.kv_cache_quant,
            ffn_int8=serve_cfg.ffn_int8, device=self._device)
        if serve_cfg.param_dtype:
            pd = getattr(torch, serve_cfg.param_dtype)
            params = {k: v.to(pd) if v.is_floating_point() else v
                      for k, v in params.items()}
        self._model = RiporModel(cfg, dtype=torch.bfloat16,
                                 device=self._device)
        self._model.load_state_dict(params)
        self._tables = tables_to_torch(succinct_tables(trie), self._device)
        super().__init__(serve_cfg, warm=warm)

    def _dispatch(self, texts: Sequence[str]):
        """Tokenize + launch one decode; returns the device tensors (the
        launches are asynchronous on the card)."""
        from ripor_tpu_torch.data.tokenizer import tokenize_queries

        ids, mask = tokenize_queries(self._tok, list(texts),
                                     self.scfg.max_length)
        scores, codes, state = self._fn(self._model, ids, mask, self._tables)
        return scores, state

    def _finish(self, handle, n: int):
        """Copy the results to the host (waits for the device) + trie
        group expansion per live query."""
        from ripor_tpu_torch.decode.beam import expand_groups_to_docids

        scores, state = (x.cpu().numpy() for x in handle)
        groups = np.where(state <= -2, -2 - state, -1)
        out = []
        for bi in range(n):
            docs, doc_scores = expand_groups_to_docids(
                self._trie, groups[bi], scores[bi], self.scfg.topk)
            out.append([(self._docids[d], float(v))
                        for d, v in zip(docs, doc_scores)])
        return out
