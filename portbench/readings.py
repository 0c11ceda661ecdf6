#!/usr/bin/env python3
"""The readings a cell's limit is set from, in one process on the card:

    python3 portbench/readings.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, one run of the cell as portbench/run.py makes it (a short
window at the cell's own load and sizes), then its sample of answers held
against the reference in the configuration's precision (``program``:
the numbers a run compares) and the control, the reference in float8 put
in the program's place (``control``: its scores of the same documents and
its own search's documents against the reference's). One JSON line a seed. The
benchmark's runs never run the control.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402


def stats(c):
    """A run's compared numbers, and the spread of its score gaps: each
    answer's quartiles of its gaps, and the reference's first 10 and 100
    documents that the answer's first 10 and 100 lack."""
    from portbench.check import numbers
    gaps = np.abs(np.concatenate(c["diffs"]))
    return {**numbers(c), "missing": c["missing"],
            "gap_quantiles_0.5_0.9_0.99": np.quantile(
                gaps, [0.5, 0.9, 0.99]).tolist(),
            "answer_gap_q25_q50_q75": [
                np.quantile(np.abs(d), [0.25, 0.5, 0.75]).tolist()
                for d in c["diffs"]],
            "missing_at_10_100": [
                [len(set(t[:k].tolist()) - set(d[:k].tolist()))
                 for k in (10, 100)]
                for t, d in zip(c["truth"], c["docs"])]}


def main(argv=None) -> int:
    from portbench import run
    run.set_cache_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = run.execute(args.workload, seed, args.seconds, False,
                        args.device, t_start=time.perf_counter(),
                        control=True)
        print(json.dumps({
            "seed": seed, "correct": r["correct"],
            "program": stats(r["compared"]), "control": stats(r["control"]),
            "metrics": r["metrics"], "device": r["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
