"""Open loop: independent users. Requests arrive on a schedule drawn from
the seed, whether or not earlier ones are answered, and go to
``RetrievalEngine.submit``. Each request is timed from when it was due to
when its future holds its answer.

The gaps between arrivals are the quantiles of the exponential
distribution of ``rate``, shuffled by the seed: Poisson arrivals, with
the same set of gaps in every seed. A request still unanswered ``grace_s`` after the window
closes is a miss, and its latency is taken at that moment.
"""
from __future__ import annotations

import math
import time

import numpy as np


def schedule(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds), ascending."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 3])
    rate = traffic["rate"]
    n = int(round(seconds * rate))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    rng.shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0]
    return due[due < seconds]


def queries_needed(traffic: dict, seconds: float) -> int:
    return len(schedule(traffic, seconds, 0)) + 64


def run(engine, queries, traffic: dict, seconds: float, seed: int,
        hooks) -> dict:
    due = schedule(traffic, seconds, seed)
    done = np.full(len(due), math.nan)
    futures = []
    lateness = 0.0
    t0 = time.perf_counter()

    def finished(i):
        def cb(_):
            done[i] = time.perf_counter() - t0
        return cb

    for i, t in enumerate(due):
        hooks.tick(time.perf_counter() - t0)
        wait = t - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        lateness = max(lateness, time.perf_counter() - t0 - t)
        f = engine.submit(queries[i % len(queries)])
        f.add_done_callback(finished(i))
        futures.append(f)
    window = max(seconds, time.perf_counter() - t0)
    hooks.close()
    deadline = t0 + window + traffic.get("grace_s", 60.0)
    for f in futures:
        left = deadline - time.perf_counter()
        if left <= 0:
            break
        try:
            f.result(timeout=left)
        except Exception:           # counted below as unanswered or failed
            pass
    answers, lat, unanswered = [], [], 0
    cut_at = deadline - t0
    for i, f in enumerate(futures):
        ok = f.done() and f.exception() is None and not math.isnan(done[i])
        if ok:
            answers.append((i % len(queries), f.result(), done[i]))
            lat.append(done[i] - due[i])
        else:
            unanswered += 1
            lat.append(cut_at - due[i])
    return {"window_s": window, "answers": answers, "attempted": len(due),
            "unanswered": unanswered, "latencies_s": lat,
            "lateness_s": lateness}
