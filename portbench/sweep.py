#!/usr/bin/env python3
"""Find a serving cell's knee once, by a sweep on the card:

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --rates <r> [<r> ...]

One engine, built and warmed as portbench/run.py builds it, then the
cell's open loop at each rate in turn for ``--seconds``. One JSON line a
rate: the latency's median and 95th percentile, the share answered, and
the backlog's growth (the mean latency of the last third of the arrivals
over the first third's). The knee is the highest rate whose backlog does
not grow; the cell's rate is fixed in its traffic file from it.
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


def main(argv=None) -> int:
    from portbench import profiling, run, spec, world
    run.set_cache_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    wl = spec.load("workloads", args.workload)
    conf, mix = spec.load("configs", wl["config"]), spec.load("traffic", 
        wl["traffic"])
    d = conf["model"]
    driver = spec.load_module("drivers", mix["arrivals"]["driver"])
    cfg = world.program_config(d)
    weights = world.make_weights(cfg, d, args.seed, "cuda",
                                 getattr(torch, conf["dtype"]))
    codes = world.make_codes(conf["corpus"], d, args.seed)
    engine = world.make_engine(cfg, weights, codes, mix["engine"], "cuda")
    engine.start()
    try:
        for rate in args.rates:
            traffic = dict(mix["arrivals"], rate=rate)
            queries = world.make_queries(
                mix["queries"], args.seed,
                driver.queries_needed(traffic, args.seconds))
            before = engine.stats()
            out = driver.run(engine, queries, traffic, args.seconds,
                             args.seed, profiling.NoTrace())
            after = engine.stats()
            lat = np.asarray(out["latencies_s"])
            third = max(1, len(lat) // 3)
            batches = (sum(after["batch_hist"].values())
                       - sum(before["batch_hist"].values()))
            print(json.dumps({
                "rate": rate, "requests": out["attempted"],
                "answered_share": len(out["answers"]) / out["attempted"],
                "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "backlog_growth": float(lat[-third:].mean()
                                        / lat[:third].mean()),
                "batch_mean": (after["served"] - before["served"])
                / max(1, batches),
                "lateness_s": out["lateness_s"]}), flush=True)
            time.sleep(1.0)
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
