#!/usr/bin/env python3
"""Run one cell of the benchmark of ripor_tpu_torch on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and engine
come from portbench/workloads/<cell>.json and the configuration file it
names; the weights, the corpus, the queries and the arrivals from the
seed. Set-up builds the engine (the kernels build into the checkout's
build/ the first time) and warms the cell's batch sizes; then the traffic
runs for ``--seconds``. After the window the answers are held against the
plain reference, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``, each
read by portbench/metrics/<name>.py), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, as also the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # the checkout's root, not portbench/, heads the import path
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ripor_tpu")


def set_cache_env():
    """Every build and kernel cache in fixed directories of the checkout;
    no library loads JAX for itself; one thread for the host's numerical
    libraries, so the engine's threads have the cores."""
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (ripor_tpu_torch is not ripor_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "not read"


def host_reading() -> dict:
    """This process's CPU seconds and the times it was switched out."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": r.ru_utime + r.ru_stime, "switched": r.ru_nivcsw}


def host_change(a: dict, b: dict, wall: float) -> str:
    """The host over the window, from two readings ``wall`` seconds
    apart: the process's CPU seconds a second (one core kept busy reads
    about 1) and the times it was switched out against its will."""
    cpu = (b["cpu_s"] - a["cpu_s"]) / wall
    return (f"host over the window: this process {cpu:.3f} CPU s a second,"
            f" switched out {b['switched'] - a['switched']} times")


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            bench=None, workload=None, conf=None, mix=None, t_start=T_START,
            log=print, control=False) -> dict:
    """One run of the cell ``name``; returns the result object. ``bench``,
    ``workload``, ``conf`` and ``mix`` default to the files found by
    name. ``control`` (portbench/readings.py, never a benchmark run) adds
    ``compared`` and ``control``: the sample against the reference, and
    the reference in float8 in the program's place against it."""
    import torch

    from portbench import check, counts, spec, world
    from portbench import profiling
    from portbench.reference import query_ids
    from portbench.reference.trie import PrefixRuns

    bench = bench or spec.load_benchmark()
    wl = workload or spec.load("workloads", name)
    conf = conf or spec.load("configs", wl["config"])
    mix = mix or spec.load("traffic", wl["traffic"])
    d, eng_spec, traffic = conf["model"], mix["engine"], mix["arrivals"]
    driver = spec.load_module("drivers", traffic["driver"])

    marks = [("start", t_start), ("imports", time.perf_counter())]
    cfg = world.program_config(d)
    weights = world.make_weights(cfg, d, seed, device,
                                 getattr(torch, conf["dtype"]))
    if device != "cpu":
        torch.cuda.synchronize(device)
    marks.append(("weights", time.perf_counter()))
    codes = world.make_codes(conf["corpus"], d, seed)
    queries = world.make_queries(mix["queries"], seed,
                                 driver.queries_needed(traffic, seconds))
    marks.append(("corpus and queries", time.perf_counter()))
    engine = world.make_engine(cfg, weights, codes, eng_spec, device)
    marks.append(("trie, engine and warm-up", time.perf_counter()))
    hooks = profiling.NoTrace()
    if trace:
        if device != "cpu":
            with profiling.profiler_warm():
                torch.zeros(1, device=device).add_(1)
        hooks = profiling.Sampler(
            engine, max(0.0, seconds - mix["trace"]["sample_s"]))
    if traffic["driver"] == "open_loop":
        engine.start()
    before = engine.stats()
    setup_s = time.perf_counter() - t_start
    log("set-up s: " + ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b)
                                 in zip(marks, marks[1:])), file=sys.stderr)
    host0 = host_reading()
    t0 = time.perf_counter()
    try:
        out = driver.run(engine, queries, traffic, seconds, seed, hooks)
    finally:
        if traffic["driver"] == "open_loop":
            engine.stop()
    log(host_change(host0, host_reading(), time.perf_counter() - t0),
        file=sys.stderr)
    after = engine.stats()
    peak = (torch.cuda.max_memory_allocated(device) if device != "cpu"
            else 0)

    rec = {"setup_s": setup_s, "window_s": out["window_s"],
           "answered": len(out["answers"]),
           "latencies_s": out.get("latencies_s"),
           "engine_served": after["served"] - before["served"],
           "engine_batches": (sum(after["batch_hist"].values())
                              - sum(before["batch_hist"].values()))}
    launches_off = 0
    if trace and hooks.done:
        rec["sample"] = hooks.record()
        rec["decode_steps"] = d["M"] * rec["sample"]["searches"]
        want = counts.search_launches(d["num_decoder_layers"], d["M"])
        got = rec["sample"]["per_search"]
        launches_off = sum(g != want for g in got)
        log(f"launches of the sample's {len(got)} searches: "
            f"{got[:1]}..., of a megarow search: {want}", file=sys.stderr)
        # the model's share of the peak over the window before the sample
        a = hooks.t0 - t0
        live = counts.live_beams(codes, d["K"], eng_spec["num_beams"],
                                 d["M"])
        rec["mfu_flops"] = sum(
            counts.search_flops(d, len(query_ids(
                queries[qi], d["vocab_size"], eng_spec["max_length"])), live)
            for qi, _, t in out["answers"] if t <= a)
        rec["mfu_seconds"] = a
        pre = sum(t <= a for _, _, t in out["answers"])
        log(f"the profiler's cost: {len(out['answers']) - pre} answers in "
            f"the sample's {hooks.wall_s:.3f} s, {pre} in the "
            f"{a:.3f} s before it", file=sys.stderr)
    group = spec.cell_metrics(bench, name, trace)
    metrics = {}
    for m in group:
        v = spec.load_module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    del engine
    if device != "cpu":
        torch.cuda.empty_cache()

    n_docs = len(codes)
    malformed = sum(not check.well_formed(r, eng_spec["topk"], n_docs)
                    for _, r, _ in out["answers"])
    failed = out["unanswered"] + malformed
    good = [a for a in out["answers"]
            if check.well_formed(a[1], eng_spec["topk"], n_docs)]
    picked = check.sample(good, queries, mix["check_queries"], seed)
    t_check = time.perf_counter()
    runs = PrefixRuns(codes, d["K"])
    compared = check.compare(picked, queries, weights, d, codes, runs,
                             eng_spec, device, conf["dtype"])
    log(f"the reference took {time.perf_counter() - t_check:.3f} s over "
        f"{len(picked)} answers", file=sys.stderr)
    numbers = {"failed": failed,
               "unsampled": mix["check_queries"] - len(picked),
               **check.numbers(compared)}
    limits = {"failed": 0, "unsampled": 0, **wl["limits"]}
    if trace and device != "cpu":        # the plain path counts no launch
        numbers["launches_off"], limits["launches_off"] = launches_off, 0
    correct = check.judge(numbers, limits)
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if device != "cpu"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and "sample" in rec:
        s = rec["sample"]
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["wall_s"]
        ops = sorted(s["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        gaps_by = sorted(s["idle_gaps"].items(), key=lambda kv: -kv[1][1])
        result["breakdown"] = {
            "device_ops": [[n[:200], t] for n, (_, t) in ops],
            "idle_gaps": [[f"{n} (x{c})"[:200], t]
                          for n, (c, t) in gaps_by[:10]]}
    if "lateness_s" in out:
        log(f"arrivals: {out['attempted']}, generator late by at most "
            f"{out['lateness_s']:.6f} s", file=sys.stderr)
    log(f"documents missed a sampled answer: {compared['missing']} of "
        f"{compared['found']}", file=sys.stderr)
    if control:
        result["compared"] = compared
        result["control"] = check.compare(picked, queries, weights, d, codes,
                                          runs, eng_spec, device,
                                          conf["dtype"], control=True)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv=None) -> int:
    set_cache_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "ripor_tpu_torch").is_dir():
        print("no ripor_tpu_torch package beside portbench/: nothing to "
              "measure", file=sys.stderr)
        return 2
    from portbench import spec
    bench = spec.load_benchmark()
    chips = spec.cell_entry(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
