"""Closed loop: one caller sends ``batch`` queries to
``RetrievalEngine.retrieve_batch`` and the next batch when the answers are
back, from the start of the window until ``seconds`` have passed; the
batch in flight then finishes and closes the window, so the rate counts
all the work and all the time of the window."""
from __future__ import annotations

import time


def queries_needed(traffic: dict, seconds: float) -> int:
    """Queries to draw: more than any window of this length completes."""
    return max(64, int(traffic["batch"] * seconds * 8))


def run(engine, queries, traffic: dict, seconds: float, seed: int,
        hooks) -> dict:
    """answers: [(query index, result, seconds into the window when it
    came back)]; batches: [(start, end) seconds into the window]."""
    B = traffic["batch"]
    answers, batches = [], []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        hooks.before_batch(time.perf_counter() - t0)
        idx = [(i + j) % len(queries) for j in range(B)]
        start = time.perf_counter() - t0
        res = engine.retrieve_batch([queries[k] for k in idx])
        end = time.perf_counter() - t0
        answers.extend((k, r, end) for k, r in zip(idx, res))
        batches.append((start, end))
        i += B
    window = time.perf_counter() - t0
    hooks.close()
    return {"window_s": window, "answers": answers,
            "attempted": i, "unanswered": 0, "batches": batches}
