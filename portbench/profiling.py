"""The traced run's sample: a short stretch of the window under
torch.profiler, with spans around the calls into the engine's layers and
the shapes of the two megarow kernels' calls, reduced to one record that
the per-layer readers (metrics/*.py) read.

Spans are the benchmark's own, put around the program's calls from here
while the sample runs and taken away after it: ``tokenize``
(tokenize_queries), ``search`` (the launch of one decode, which issues
every kernel of the search without waiting for the device), ``finish``
(the wait for the results and their copy to the host) and ``expand``
(the smtid groups expanded to docids). The sources of every
reorder_cache_all call are kept (a copy on the device), since the bytes
that kernel reads depend on how many distinct beams it copies.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

from portbench import counts

K1 = "reorder_cache_all_kernel"
K2 = "step_attention_seq_kernel"
SPANS = ("tokenize", "search", "finish", "expand")


class NoTrace:
    """The hooks of an untraced run: nothing happens."""

    def before_batch(self, now):
        pass

    def tick(self, now):
        pass

    def close(self):
        pass


class Sampler(NoTrace):
    """Profiles the end of the window: from ``start_s`` seconds into it (a
    closed loop: from the first batch that starts after it) to its close,
    so that the profiler's own stop, which collects the trace, falls
    after the window."""

    def __init__(self, engine, start_s: float):
        self.engine = engine
        self.start_s = start_s
        self.prof = None
        self.done = False
        self.t0 = self.t1 = None
        self.per_search: List[Dict[str, int]] = []
        self.k1: List[tuple] = []
        self.k2: List[int] = []
        self._undo = []

    # -- the hooks ----------------------------------------------------------

    def before_batch(self, now):
        self.tick(now)

    def tick(self, now):
        if self.prof is None and not self.done and now >= self.start_s:
            self.start()

    def close(self):
        """The window has closed (the closed loop's last batch is back,
        the open loop's last request is sent)."""
        if self.prof is not None and not self.done:
            self.stop()

    # -- the sample ---------------------------------------------------------

    def _wrap(self, owner, attr, span=None, before=None):
        import torch
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            if before is not None:
                before(*a, **kw)
            if span is None:
                return orig(*a, **kw)
            with torch.profiler.record_function(span):
                return orig(*a, **kw)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def _k1_call(self, kvg, cache_src, cache_dst, src, t, *a, **kw):
        self.k1.append((tuple(cache_src.shape), cache_src.element_size(),
                        kvg.shape[2] * kvg.element_size(), src.clone()))

    def _k2_call(self, q, kv_new, cache, layer, bias_hist, bias_new, H,
                 emit_quant=None, **kw):
        B, N, F = q.shape
        Mc, RW = cache.shape[3], cache.shape[4] * cache.element_size()
        self.k2.append((counts.k2_bytes(B, N, F, H, Mc, RW, q.element_size(),
                                        emit_quant is not None),
                        counts.k2_flops(B, N, F, Mc)))

    def _wrap_search(self, eng):
        """Count each search the sample launches, and the kernels that
        search launched (the launch of a search issues all its kernels
        before it returns)."""
        import torch
        from ripor_tpu_torch.ops import KERNEL_LAUNCHES
        orig = eng._fn

        def search(*a, **kw):
            before = dict(KERNEL_LAUNCHES)
            with torch.profiler.record_function("search"):
                out = orig(*a, **kw)
            self.per_search.append({k: v - before.get(k, 0)
                                    for k, v in KERNEL_LAUNCHES.items()
                                    if v - before.get(k, 0)})
            return out
        eng._fn = search
        self._undo.append((eng, "_fn", orig))

    def start(self):
        import torch
        import ripor_tpu_torch.data.tokenizer as tokenizer
        import ripor_tpu_torch.decode.beam as beam
        import ripor_tpu_torch.models.t5 as t5
        from torch.profiler import profile
        eng = self.engine
        self._wrap(tokenizer, "tokenize_queries", "tokenize")
        self._wrap(beam, "expand_groups_to_docids", "expand")
        self._wrap_search(eng)
        self._wrap(eng, "_finish", "finish")
        self._wrap(t5, "reorder_cache_all", before=self._k1_call)
        self._wrap(t5, "step_attention_seq", before=self._k2_call)
        self.prof = profile(activities=activities(),
                            experimental_config=all_threads())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()
        self.done = True

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def record(self) -> dict:
        """The sample reduced: device intervals, time by kernel, the idle
        gaps labelled by the host's span and runtime call, the megarow
        kernels' bytes and times, and the launch counters."""
        import torch
        from torch.autograd import DeviceType
        events = self.prof.events()
        dev, host = [], []
        for e in events:
            r = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
            if e.device_type != DeviceType.CUDA:
                host.append(r)
            elif not getattr(e, "is_user_annotation", False) \
                    and e.name not in SPANS:
                # the spans' copies on the device's timeline are not work
                dev.append(r)
        dev.sort()
        busy, reach, segments = 0.0, float("-inf"), []
        by_name: Dict[str, List[float]] = {}
        for s, e, n in dev:
            if s > reach:
                segments.append([s, e])
            else:
                segments[-1][1] = max(segments[-1][1], e)
            busy += max(0.0, e - max(s, reach))
            reach = max(reach, e)
            c = by_name.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += e - s
        gaps = [(a[1], b[0]) for a, b in zip(segments, segments[1:])
                if b[0] > a[1]]
        k1_bytes = 0
        for shape, esize, kvg_row, src in self.k1:
            B, N, L, Mc, RW = shape
            uniq = sum(int(torch.unique(src[b]).numel()) for b in range(B))
            k1_bytes += counts.k1_bytes(B, N, L, Mc, RW * esize, uniq,
                                        kvg_row // L)
        return {
            "wall_s": self.wall_s,
            "busy_s": busy,
            "searches": len(self.per_search),
            "kernels": by_name,
            "idle_gaps": label_gaps(gaps, host),
            "k1": {"calls": len(self.k1), "bytes": k1_bytes,
                   "seconds": kernel_seconds(by_name, K1),
                   "launches": kernel_count(by_name, K1)},
            "k2": {"calls": len(self.k2),
                   "bytes": sum(b for b, _ in self.k2),
                   "flops": sum(f for _, f in self.k2),
                   "seconds": kernel_seconds(by_name, K2),
                   "launches": kernel_count(by_name, K2)},
            "per_search": self.per_search,
        }


def activities():
    from torch.profiler import ProfilerActivity
    import torch
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])


def all_threads():
    """The profiler's setting that records the host events of every
    thread (the serving engine's batcher and completer too), where this
    torch has it."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:            # a torch without the setting
        return None


def kernel_seconds(by_name, part: str) -> float:
    return sum(s for n, (_, s) in by_name.items() if part in n)


def kernel_count(by_name, part: str) -> int:
    return sum(c for n, (c, _) in by_name.items() if part in n)


def label_gaps(gaps, host) -> Dict[str, List[float]]:
    """Each idle gap of the device labelled by what the host was doing at
    its middle: the benchmark's span there (or "outside the engine"), and
    the CUDA runtime call in progress (or "python": the host between
    calls). Returns label -> [count, seconds]."""
    import numpy as np
    spans = [h for h in host if h[2] in SPANS]
    calls = sorted(h for h in host if h[2].startswith("cu"))
    starts = np.array([c[0] for c in calls])
    ends = np.array([c[1] for c in calls])
    out: Dict[str, List[float]] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        span = min((h for h in spans if h[0] <= mid <= h[1]),
                   key=lambda h: h[1] - h[0], default=None)
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        call = calls[i][2] if i >= 0 and ends[i] >= mid else "python"
        label = f"{span[2] if span else 'outside the engine'}: {call}"
        c = out.setdefault(label, [0, 0.0])
        c[0] += 1
        c[1] += b - a
    return out


@contextlib.contextmanager
def profiler_warm():
    """Start and stop the profiler once in set-up, so the traced sample
    does not pay its first start."""
    import torch
    from torch.profiler import profile
    with profile(activities=activities()):
        yield
        torch.cuda.synchronize()
