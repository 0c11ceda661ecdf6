"""Microbatching retrieval engines, in PyTorch: the megarow beam search
and dense MIPS.

Port of ripor_tpu/serve/engine.py (``ServeConfig``, ``BaseEngine``,
``RetrievalEngine``, ``DenseEngine``). An engine pads every microbatch to
a rung of a small ladder of batch sizes, and coalesces concurrent
requests into one device call: a batcher thread drains the request queue,
waits at most ``max_delay_ms`` for co-riders, then dispatches.

``retrieve_batch`` is the synchronous path; ``submit`` returns a Future.
The decode is asynchronous on the card (the beam loop issues no host
sync), so the batcher dispatches batch N+1 while a completion thread
waits for batch N's results and expands them to docids.

On a mesh of more than one rank the engine is SPMD, and the first rank
plays the JAX package's single controller: every rank calls ``start``
and ``stop``; only the first rank takes ``submit`` (and so HTTP). Its
batcher broadcasts each batch's texts to the other ranks, whose follower
thread runs the same decode, so every collective of the search runs on
every rank in the same order. One thread a rank issues collectives.
"""
from __future__ import annotations

import datetime
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


_STOP = None    # the first rank's last broadcast: the followers return
# the batches' group waits this long for the next batch: a follower of an
# idle server waits on, and a rank that dies fails the others at once
CTL_TIMEOUT = datetime.timedelta(days=365)


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

    A subclass that serves a mesh of more than one rank sets ``_ctl``, the
    gloo group the first rank broadcasts each batch over, and on the other
    ranks ``_follows`` (module docstring).
    """

    _ctl = None
    _follows = False

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
        # the exception that ended the batcher or the follower on a mesh;
        # stop() re-raises it
        self._error: Optional[Exception] = None
        # the card the engine was built on ("cuda": the current one)
        dev = getattr(self, "_device", None)
        self._cuda_index = None
        if dev is not None and dev.type == "cuda":
            import torch
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())
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

    @property
    def follows(self) -> bool:
        """Whether this rank follows the first rank's batches (a mesh of
        more than one rank, any rank but the first)."""
        return self._follows

    def _bind_device(self):
        """Make the engine's card current in this thread (a thread starts
        on card 0)."""
        if self._cuda_index is not None:
            import torch
            torch.cuda.set_device(self._cuda_index)

    def start(self):
        """Start the batcher + completion threads (idempotent; restartable
        after stop()); on a follower rank, the follower thread."""
        if self._follows:
            if self._thread is None or not self._thread.is_alive():
                self._error = None
                self._thread = threading.Thread(target=self._follow_loop,
                                                name="ripor-follower",
                                                daemon=True)
                self._thread.start()
            return
        if self._thread is None or not self._thread.is_alive():
            self._error = None
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

    def follow(self):
        """On a follower rank: start, and return when the first rank has
        stopped the engine (re-raising the follower's exception)."""
        self.start()
        self._thread.join()
        self.stop()

    def stop(self):
        """Stop the batcher and FAIL any still-queued requests (a future
        that never resolves deadlocks its client). Waits for the batcher to
        exit, then for the completion thread to drain every in-flight
        batch, before draining the queue. On a mesh the first rank's
        batcher tells the followers to return; a follower's stop() waits
        (up to ``stop_join_timeout_s``) for that. The exception that ended
        the batcher or the follower, if one did, is raised here."""
        self._stop.set()
        timeout = self.scfg.stop_join_timeout_s
        if self._follows:
            if self._thread is not None:
                self._thread.join(timeout=timeout)
                if self._thread.is_alive():
                    raise RuntimeError(
                        f"the first rank did not stop the engine within "
                        f"{timeout:.0f} s; this rank's follower still waits")
            self._raise_error()
            return
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
        self._raise_error()

    def _raise_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, text: str) -> Future:
        """Enqueue one query; the Future resolves to its top-k list.
        Requires start(); concurrent submitters share device batches. On a
        mesh only the first rank takes requests."""
        if self._follows:
            raise ValueError(
                "submit is taken by the first rank of the mesh only; this "
                "rank follows its batches (call start() and stop() here)")
        req = _Request(text, Future())
        if self._error is not None:
            req.future.set_exception(self._error)
        else:
            self._q.put(req)
        return req.future

    def _broadcast(self, texts):
        from ripor_tpu_torch.core.mesh import broadcast_object
        broadcast_object(texts, self._ctl)

    def _follow_loop(self):
        """A follower rank: run each batch the first rank broadcasts, in
        its order, until the stop sentinel."""
        from ripor_tpu_torch.core.mesh import broadcast_object
        try:
            self._bind_device()
            while True:
                texts = broadcast_object(None, self._ctl)
                if texts is _STOP:
                    return
                self._decode(texts)
        except Exception as e:          # re-raised by stop()
            self._error = e

    def _batch_loop(self):
        """The batcher thread: ``_batches`` until stop(); on a mesh its
        exception fails the queued requests and is kept for stop(), and
        its last broadcast ends the followers."""
        try:
            self._bind_device()
            self._batches()
        except Exception as e:          # a mesh's ranks are out of step
            self._error = e
            self._fail_queued(e)
        finally:
            if self._ctl is not None:
                try:
                    self._broadcast(_STOP)
                except Exception as e:
                    self._error = self._error or e

    def _fail_queued(self, err):
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if not req.future.done():
                req.future.set_exception(err)

    def _batches(self):
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
            texts = [r.text for r in batch] + [""] * (rung - len(batch))
            try:
                if self._ctl is not None:
                    self._broadcast(texts)
                handle = self._dispatch(texts)
            except Exception as e:      # surface device errors per request
                for r in batch:
                    r.future.set_exception(e)
                if self._ctl is not None:
                    raise               # the ranks' collectives disagree
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
    CUDA raises RuntimeError).

    ``mesh``: queries split over the mesh's 'data' axis
    (decode/beam.py::make_sharded_beam_search_fn), so every rung of
    ``batch_sizes`` must divide it. The engine is then SPMD: every rank
    builds it, and either every rank calls ``retrieve_batch`` with the
    same texts, or every rank calls ``start()``/``stop()`` and the first
    rank alone ``submit`` (or serve/http.py::serve_http), whose batches
    the other ranks follow (module docstring)."""

    def __init__(self, cfg, params, tok, trie, docids: Sequence[str],
                 serve_cfg: ServeConfig = ServeConfig(), warm: bool = True,
                 mesh=None, device=None):
        import torch

        from ripor_tpu_torch.core.mesh import DATA_AXIS, axis_size
        from ripor_tpu_torch.decode.beam import (make_beam_search_fn,
                                                 make_sharded_beam_search_fn,
                                                 resolve_device)
        from ripor_tpu_torch.decode.quant_gate import ensure_quant_validated
        from ripor_tpu_torch.models.ripor import RiporModel
        from ripor_tpu_torch.trie.succinct import (succinct_tables,
                                                   tables_to_torch)

        ensure_quant_validated(serve_cfg.kv_cache_quant,
                               bool(serve_cfg.ffn_int8),
                               ckpt_dir=serve_cfg.ckpt_dir)
        self._device = resolve_device(device)
        self.cfg = cfg
        self._tok = tok
        self._trie = trie
        self._docids = list(docids)
        self._mesh = mesh
        kw = dict(constrained=serve_cfg.constrained,
                  kv_cache_quant=serve_cfg.kv_cache_quant,
                  ffn_int8=serve_cfg.ffn_int8, device=self._device)
        if mesh is not None:
            ndata = axis_size(mesh, DATA_AXIS)
            bad = [b for b in serve_cfg.batch_sizes if b % ndata != 0]
            if bad:
                raise ValueError(
                    f"batch_sizes {bad} do not divide the mesh 'data' axis "
                    f"({ndata}) — pick rungs that are multiples of it")
            self._fn = make_sharded_beam_search_fn(
                cfg, serve_cfg.num_beams, mesh, **kw)
        else:
            self._fn = make_beam_search_fn(cfg, serve_cfg.num_beams, **kw)
        if serve_cfg.param_dtype:
            pd = getattr(torch, serve_cfg.param_dtype)
            params = {k: v.to(pd) if v.is_floating_point() else v
                      for k, v in params.items()}
        self._model = RiporModel(cfg, dtype=torch.bfloat16,
                                 device=self._device)
        self._model.load_state_dict(params)
        self._tables = tables_to_torch(succinct_tables(trie), self._device)
        if mesh is not None and mesh.size() > 1:
            import torch.distributed as dist

            from ripor_tpu_torch.core.mesh import is_first_process
            # the batches' own group: host objects, apart from the search's
            # collectives (every rank makes it, in the same order)
            self._ctl = dist.new_group(backend="gloo", timeout=CTL_TIMEOUT)
            self._follows = not is_first_process()
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


class DenseEngine(BaseEngine):
    """Query text -> top-k (docid, score) by exact MIPS over a corpus held
    on the device (evaluation/retriever.py::dense_topk — the single-card
    replacement for the reference's 8-GPU faiss shard,
    tasks/evaluator.py:694-831). ``corpus``: a tensor or an Int8Corpus
    from retriever.device_corpus, used where it lies, or an [N, d] array,
    uploaded once as bf16 to ``device`` ("cuda" unless the caller passes
    another). The query encoder (RiporModel.dense_rep) runs in ``dtype``
    (default bfloat16) on ``device``; ``params`` is a state_dict.
    ``approx`` is accepted and exact (retriever.py)."""

    def __init__(self, cfg, params, tok, corpus, docids: Sequence[str],
                 serve_cfg: ServeConfig = ServeConfig(), warm: bool = True,
                 approx: bool = False, dtype=None, device=None):
        import torch

        from ripor_tpu_torch.decode.beam import resolve_device
        from ripor_tpu_torch.evaluation.retriever import (Int8Corpus,
                                                          device_corpus)
        from ripor_tpu_torch.models.ripor import RiporModel

        self._device = resolve_device(device)
        self.cfg = cfg
        self._tok = tok
        self._docids = list(docids)
        self._approx = approx
        self._corpus = (corpus
                        if isinstance(corpus, (torch.Tensor, Int8Corpus))
                        else device_corpus(corpus, device=self._device))
        self._model = RiporModel(cfg, dtype=dtype or torch.bfloat16,
                                 device=self._device)
        self._model.load_state_dict(params)
        super().__init__(serve_cfg, warm=warm)

    def _dispatch(self, texts: Sequence[str]):
        """Tokenize + launch the query encoder (asynchronous on the card)."""
        import torch

        from ripor_tpu_torch.data.tokenizer import tokenize_queries

        ids, mask = tokenize_queries(self._tok, list(texts),
                                     self.scfg.max_length)
        with torch.inference_mode():
            return self._model.dense_rep(
                torch.as_tensor(ids, device=self._device),
                torch.as_tensor(mask, device=self._device))

    def _finish(self, reps, n: int):
        from ripor_tpu_torch.evaluation.retriever import dense_topk

        scores, idx = dense_topk(reps.float().cpu().numpy(), self._corpus,
                                 self.scfg.topk, approx=self._approx)
        return [[(self._docids[d], float(v)) for d, v in zip(qi, qs)]
                for qi, qs in zip(idx[:n], scores[:n])]
