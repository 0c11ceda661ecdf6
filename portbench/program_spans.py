"""The program's own spans in a traced run's sample: ``codebook_head``
and ``select``, which ripor_tpu_torch/decode/beam.py puts around each
megarow step's head over the codebook and its select (the trie mask, the
top-k and the beams' bookkeeping) with torch.profiler.record_function.

For each host range of such a span the profiler emits a user annotation
on the device's timeline that covers the kernels launched inside it,
graph replays included. ``span_times`` reduces those to ``{name: [count,
device seconds]}``. The sample's record (profiling.Sampler.record) keeps
no events, so ``read`` takes them from the Sampler that made the record,
which the run reading the record's metrics (run.execute) holds: the
record's ``per_search`` list is the Sampler's own. A record without a
traced sample, a run on the CPU, or a program without the spans gives
None.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

NAMES = ("codebook_head", "select")


def sampler_of(rec: dict):
    """The profiling.Sampler that recorded ``rec["sample"]``, found in
    the frames of the callers, or None."""
    from portbench.profiling import Sampler
    sample = rec.get("sample")
    if not sample or "per_search" not in sample:
        return None
    mark = sample["per_search"]
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, Sampler) and v.per_search is mark:
                return v
        f = f.f_back
    return None


def span_times(events) -> Dict[str, List[float]]:
    """The device-side annotations of the spans in NAMES among profiler
    events: name -> [count, summed seconds]."""
    from torch.autograd import DeviceType
    out: Dict[str, List[float]] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name in NAMES:
            c = out.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += (e.time_range.end - e.time_range.start) / 1e6
    return out


def read(rec: dict) -> Optional[dict]:
    """The spans of the record's sample, with what their work is counted
    from: ``spans`` (span_times), ``steps`` (each profiled decode step's
    queries and beams, from its reorder_cache_all call), and the
    configuration's ``K``, ``M`` and ``d_model``. None where there are no
    spans to read."""
    smp = sampler_of(rec)
    if smp is None or smp.prof is None:
        return None
    spans = span_times(smp.prof.events())
    if not spans:
        return None
    cfg = smp.engine.cfg
    return {"spans": spans,
            "steps": [tuple(shape[:2]) for shape, *_ in smp.k1],
            "K": cfg.K, "M": cfg.M, "d_model": cfg.t5.d_model}
