"""RIPOR's 16x1024 geometry on the CPU: the program against the plain
reference at M = 16, K = 1,024 (toy widths, float32), the offline cell's
rehearsal, control and test_faults' faults at the toy size keeping the
configuration's M and K (toy.py's toy_files puts M = 8, K = 32 in their
place), and the program's ``codebook_head`` and ``select`` spans with the
counts and readers of the metrics that read them. The faults also run on
a card at the cell's own size."""
import time
import types

import numpy as np
import pytest
import torch

from portbench import program_spans, spec, world
from portbench.check import judge, numbers
from portbench.profiling import Sampler
from portbench.reference import Reference
from portbench.reference.trie import PrefixRuns
from portbench.run import execute
from portbench.search_counts import head_bound_s, head_work, select_bytes
from portbench.tests.test_faults import (half_batch, state_unchanged,
                                        token_altered)
from portbench.tests.toy import TOY_MODEL, toy_files

CELL = "t5base-16x1024-offline-b1000"
CONF = spec.load("configs", "ripor-t5base-16x1024-nbits10")["model"]
D = dict(TOY_MODEL, M=CONF["M"], K=CONF["K"])
# toy readings at M=16, K=1024 (seeds 1-3, 99 and 2^31+7, the reference in
# bfloat16, the int4 cache): sound runs read score_gap 0.88-1.51, its
# median 0.24-0.33 and worst_median_gap 0.25-0.51; the float8 control
# 5.0-9.96, 2.1-3.9 and 2.29-3.91
TOY_1024_LIMITS = {"score_gap": 3.0, "score_gap_median": 0.8,
                   "worst_median_gap": 1.0}
READERS = ["select_ms_per_step.offline", "select_roofline.offline",
           "codebook_head_roofline.offline"]


def search_1024(seed=5, docs=2000, beams=20):
    from ripor_tpu_torch.decode.beam import make_beam_search_fn
    from ripor_tpu_torch.models.ripor import RiporModel
    from ripor_tpu_torch.trie import build_trie, succinct_tables, \
        tables_to_torch
    cfg = world.program_config(D)
    weights = world.make_weights(cfg, D, seed, "cpu", torch.float32)
    codes = world.make_codes({"docs": docs, "narrow_levels": 4}, D, seed)
    model = RiporModel(cfg, dtype=torch.float32)
    model.load_state_dict(weights)
    fn = make_beam_search_fn(cfg, beams, dtype=torch.float32, device="cpu")
    ids = torch.tensor([[5, 9, 33, 1, 0, 0], [7, 8, 1, 0, 0, 0]])
    tables = tables_to_torch(succinct_tables(build_trie(codes, D["K"])),
                             "cpu")
    scores, paths, _ = fn(model, ids, (ids > 0).int(), tables)
    return weights, codes, ids, scores, paths


def test_reference_scores_and_finds_the_programs_beams_at_1024_codes():
    """float32, an exact cache, TF32 off: the reference's teacher-forced
    scores of the program's beams within 1e-4, and its own search finds
    the same beams."""
    from portbench.reference import exact_float32
    weights, codes, ids, scores, paths = search_1024()
    assert paths.shape[-1] == 16 and int(paths.max()) >= 256
    ref = Reference(weights, D, "cpu")
    with exact_float32():
        encs = [ref.encode(ids[b, :int((ids[b] > 0).sum())])
                for b in range(2)]
        got = ref.path_scores(encs, [paths[0], paths[1]])
        found = ref.search(encs, PrefixRuns(codes, D["K"]), 20, 20)
    for b in range(2):
        assert (got[b] - scores[b].double()).abs().max() < 1e-4
        assert ({tuple(codes[x]) for x in found[b]}
                == {tuple(p) for p in paths[b].tolist()})


def toy_files_1024(cell):
    """toy_files' cell, with the configuration's own M and K, at limits
    read at this size."""
    wl, conf, mix = toy_files(cell)
    wl = dict(wl, limits={k: v for k, v in TOY_1024_LIMITS.items()
                          if k in wl["limits"]})
    full = spec.load("configs", wl["config"])["model"]
    conf = dict(conf, model=dict(conf["model"], M=full["M"], K=full["K"]))
    return wl, conf, mix


def run_toy_1024(seed=2 ** 31 + 7, trace=False, control=False):
    wl, conf, mix = toy_files_1024(CELL)
    return execute(CELL, seed, 1.5, trace, "cpu", workload=wl, conf=conf,
                   mix=mix, t_start=time.perf_counter(),
                   log=lambda *a, **k: None, control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_at_the_toy_size_keeping_m_and_k(trace):
    r = run_toy_1024(trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in spec.cell_metrics(spec.load_benchmark(),
                                                  CELL, trace)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_control_fails_at_1024_codes():
    r = run_toy_1024(seed=3, control=True)
    program, control = numbers(r["compared"]), numbers(r["control"])
    assert judge(program, TOY_1024_LIMITS)
    assert not judge(control, TOY_1024_LIMITS)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered])
def test_fault_fails_the_check_at_1024_codes(fault, monkeypatch):
    """test_faults' faults of the int4 offline cell, at the toy size
    keeping the configuration's M and K."""
    fault(monkeypatch)
    r = run_toy_1024()
    assert not r["correct"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in r["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("fault,seed", [
    (state_unchanged, 7200000001), (half_batch, 7200000002),
    (half_batch, 7200000003), (token_altered, 7200000004)])
def test_fault_fails_the_1024_cell_on_the_card(fault, seed, monkeypatch):
    """The cell as committed (its sizes, its files, its limits), a short
    window on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.run import set_cache_env
    set_cache_env()
    fault(monkeypatch)
    r = execute(CELL, seed, 3.0, False, "cuda",
                t_start=time.perf_counter(), log=lambda *a, **k: None)
    print(fault.__name__, seed, r["checks"])
    assert not r["correct"]


def test_select_and_head_counts_at_the_cells_shapes():
    """B=8, N=1000, K=1024, M=16, d=768: 4,376 bytes a beam in the
    select; 12.58 GFLOP and 46.6 MB in the head, bound by its bytes."""
    assert select_bytes(8, 1000, 1024, 16) == 8000 * (4096 + 128 + 128 + 24)
    assert select_bytes(8, 1000, 256, 32) == 8000 * (1024 + 32 + 256 + 24)
    flops, nbytes = head_work(8, 1000, 768, 1024)
    assert flops == 2 * 8000 * 768 * 1024 == 12_582_912_000
    assert nbytes == 12_288_000 + 1_572_864 + 32_768_000
    assert head_bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert head_bound_s(flops, 0) == pytest.approx(flops / 989e12)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_without_spans(name):
    reader = spec.load_module("metrics", name)
    assert reader.read({"window_s": 1.0, "setup_s": 1.0}) is None
    # a sample whose Sampler no caller holds (a record read elsewhere)
    rec = {"window_s": 1.0, "decode_steps": 32,
           "sample": {"per_search": [], "kernels": {}, "busy_s": 1.0,
                      "wall_s": 1.5}}
    assert reader.read(rec) is None


def fake_sampler(spans, steps, events_extra=()):
    """A Sampler whose profiler holds device annotations of the program's
    spans (durations in seconds) and whose K1 calls give the steps."""
    from torch.autograd import DeviceType
    s = Sampler(types.SimpleNamespace(cfg=world.program_config(CONF)), 0.0)
    events = []
    for name, durations in spans.items():
        for i, d in enumerate(durations):
            events.append(types.SimpleNamespace(
                name=name, device_type=DeviceType.CUDA,
                time_range=types.SimpleNamespace(start=10.0 * i,
                                                 end=10.0 * i + d * 1e6)))
    events += list(events_extra)
    s.prof = types.SimpleNamespace(events=lambda: events)
    s.k1 = [((B, N, 12, 16, 896), 1, 896, None) for B, N in steps]
    return s


def test_span_readers_read_the_samplers_spans():
    """The readers find the Sampler that recorded the sample in their
    caller's frame, and read its device annotations."""
    from torch.autograd import DeviceType
    steps = [(8, 1000)] * 16
    kernel = types.SimpleNamespace(
        name="void at::native::elementwise", device_type=DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=0.0, end=1e6))
    host = types.SimpleNamespace(
        name="select", device_type=DeviceType.CPU,
        time_range=types.SimpleNamespace(start=0.0, end=5e6))
    smp = fake_sampler({"select": [1e-3] * 16, "codebook_head": [2e-4] * 16},
                       steps, [kernel, host])
    rec = {"decode_steps": 16, "sample": {"per_search": smp.per_search}}
    got = {n: spec.load_module("metrics", n).read(rec) for n in READERS}
    assert got["select_ms_per_step.offline"] == pytest.approx(1.0)
    sel = 16 * select_bytes(8, 1000, 1024, 16) / 3.35e12
    assert got["select_roofline.offline"] == pytest.approx(
        100 * sel / 16e-3)
    head = 16 * head_work(8, 1000, 768, 1024)[1] / 3.35e12
    assert got["codebook_head_roofline.offline"] == pytest.approx(
        100 * head / 3.2e-3)
    # spans that do not match the profiled steps one for one: no reading
    smp.k1 = smp.k1[:-1]
    for n in READERS:
        assert spec.load_module("metrics", n).read(rec) is None
    del smp


def test_the_search_emits_its_spans_each_step():
    """A megarow search on the CPU opens one ``codebook_head`` and one
    ``select`` range a step on the host, each inside the search."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        search_1024(docs=300, beams=8)
    names = [e.name for e in prof.events()]
    assert names.count("codebook_head") == D["M"]
    assert names.count("select") == D["M"]


def test_program_spans_in_a_toy_traced_run(monkeypatch):
    """Through run.execute's traced run: with the host ranges standing in
    for the device annotations the CPU has not, the three readers read
    the sample's spans, one a profiled step."""
    from torch.autograd import DeviceType
    counts = {}

    def host_times(events):
        out = {}
        for e in events:
            if e.device_type == DeviceType.CPU and e.name in \
                    program_spans.NAMES:
                c = out.setdefault(e.name, [0, 0.0])
                c[0] += 1
                c[1] += (e.time_range.end - e.time_range.start) / 1e6
        counts.update(out)
        return out
    monkeypatch.setattr(program_spans, "span_times", host_times)
    r = run_toy_1024(trace=True)
    assert set(READERS) <= set(r["metrics"])
    assert counts["select"][0] == counts["codebook_head"][0] > 0
    assert counts["select"][0] % D["M"] == 0
    assert r["metrics"]["select_ms_per_step.offline"]["value"] > 0
