"""A cell of the benchmark cut to a size the CPU runs in seconds: the
toy model of the port's tests (ripor_small's widths), 3,000 documents,
beam 16, and limits read from that size."""
from __future__ import annotations

import time

from portbench import spec
from portbench.run import execute

TOY_MODEL = {"vocab_size": 512, "d_model": 64, "d_kv": 16, "num_heads": 4,
             "d_ff": 128, "num_layers": 2, "num_decoder_layers": 2,
             "relative_attention_num_buckets": 32,
             "relative_attention_max_distance": 128,
             "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu",
             "M": 8, "K": 32}
# toy readings (seeds 1-3 and 99, the reference in bfloat16): sound runs
# read score_gap 0.27-0.90 and its median 0.08-0.19; the float8 control
# 3.3-7.1 and 0.88-1.5. (beam_miss over 64 documents is too coarse here.)
TOY_LIMITS = {"score_gap": 2.0, "score_gap_median": 0.5,
              "worst_median_gap": 0.5}


def toy_files(cell: str):
    """(workload, configuration, traffic) of ``cell`` at the toy size: the
    numbers the cell compares, at limits read at this size."""
    wl = spec.load("workloads", cell)
    wl = dict(wl, limits={k: v for k, v in TOY_LIMITS.items()
                          if k in wl["limits"]})
    conf = dict(spec.load("configs", wl["config"]), model=dict(TOY_MODEL),
                corpus={"docs": 3000, "narrow_levels": 2})
    mix = spec.load("traffic", wl["traffic"])
    # the whole window is profiled, so a slow host still takes a sample
    mix = dict(mix, engine=dict(mix["engine"], num_beams=16, topk=16),
               check_queries=2, trace={"sample_s": 1.5})
    if mix["arrivals"]["driver"] == "open_loop":
        mix["arrivals"] = dict(mix["arrivals"], rate=20.0)
        mix["engine"]["batch_sizes"] = [1, 4, 8]
    else:
        mix["arrivals"] = dict(mix["arrivals"], batch=2)
        mix["engine"]["batch_sizes"] = [2]
    return wl, conf, mix


def run_toy(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
            trace: bool = False, device: str = "cpu", control=False):
    wl, conf, mix = toy_files(cell)
    return execute(cell, seed, seconds, trace, device, workload=wl,
                   conf=conf, mix=mix, t_start=time.perf_counter(),
                   log=lambda *a, **k: None, control=control)
