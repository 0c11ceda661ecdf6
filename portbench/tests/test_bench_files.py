"""BENCHMARK.json and the files it names: found by name, names and units
of the allowed characters, and a new configuration, cell and metric found
by their files alone."""
import json
import shutil

import pytest

from portbench import counts, spec

BENCH = spec.load_benchmark()


def test_benchmark_has_no_problems():
    assert spec.problems(BENCH) == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    entry = spec.cell_entry(BENCH, cell)
    wl = spec.load("workloads", cell)
    conf = spec.load("configs", wl["config"])
    mix = spec.load("traffic", wl["traffic"])
    assert wl["config"] == entry["config"] and conf["name"] == entry["config"]
    assert spec.load_module("drivers", mix["arrivals"]["driver"]).run
    for trace in (False, True):
        for m in spec.cell_metrics(BENCH, cell, trace):
            assert spec.load_module("metrics", m["name"]).read
    assert wl["limits"]
    assert set(wl["limits"]) <= {"score_gap", "score_gap_median",
                                 "worst_median_gap", "beam_miss"}


def test_units_and_names():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as files and entries; nothing here is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "portbench"
    conf = json.loads((here / "configs/ripor-t5base-32x256.json").read_text())
    conf["name"] = "ripor-t5large-32x256"
    conf["model"].update(d_model=1024, d_ff=4096, num_heads=16,
                         num_layers=24, num_decoder_layers=24)
    (here / "configs/ripor-t5large-32x256.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic/serve-b100-poisson.json").read_text())
    mix["arrivals"] = {"driver": "open_loop", "grace_s": 60.0, "rate": 50.0}
    (here / "traffic/serve-b100-poisson50.json").write_text(json.dumps(mix))
    why = "Poisson arrivals at 50 queries a second"
    (here / "workloads/t5large-serve-50.json").write_text(json.dumps(
        {"name": "t5large-serve-50", "config": "ripor-t5large-32x256",
         "traffic": "serve-b100-poisson50", "chips": 1, "why": why,
         "limits": {"score_gap": 1.0, "score_gap_median": 1.0}}))
    (here / "metrics/queue_wait_ms.serve.py").write_text(
        "def read(rec):\n    return rec.get('queue_wait_ms')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "ripor-t5large-32x256",
                             "source": conf["source"],
                             "file": "portbench/configs/"
                                     "ripor-t5large-32x256.json",
                             "reduced": ["corpus", "weights"], "why": why})
    bench["workloads"].append({"name": "t5large-serve-50",
                               "config": "ripor-t5large-32x256",
                               "traffic": "serve-b100-poisson50", "chips": 1,
                               "why": why})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_p95_ms":
            m["workloads"].append("t5large-serve-50")
    bench["per_layer"].append({
        "name": "queue_wait_ms.serve", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "serving engine",
        "moves": "serve_p95_ms", "workloads": ["t5large-serve-50"]})
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", root)
    assert spec.problems(bench) == []
    names = [m["name"] for m in spec.cell_metrics(
        bench, "t5large-serve-50", True)]
    assert "queue_wait_ms.serve" in names
    reader = spec.load_module("metrics", "queue_wait_ms.serve")
    assert reader.read({"queue_wait_ms": 3.0}) == 3.0
    driver = spec.load_module("drivers", "open_loop")
    due = driver.schedule(mix["arrivals"], 8.0, 5)
    assert len(due) == 8 * 50
    assert (due[:-1] <= due[1:]).all() and due[-1] < 8.0


def test_broken_entries_are_named():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["unit"] = "queries per batch"
    bench["workloads"][0]["traffic"] = "no-such-mix"
    found = " ".join(spec.problems(bench))
    assert "bad unit" in found and "no-such-mix" in found


def test_k1_bytes_as_the_kernel_table_counts_them():
    """t5-base, B=8, N=1000, L=12, Mc=32, int4 rows: the kernel table's
    4.60 GB a call (bound 1.374 ms at 3.35 TB/s) for the distinct sources
    of its draw; a uniform draw of sources has 5,057.5 distinct on average,
    0.5 % fewer bytes."""
    RW = 768 + 128       # a packed int4 K|V row of 2 x 768 and its exponents
    assert round(counts.k1_bytes(8, 1000, 12, 32, RW, 5128, RW) / 1e9,
                 2) == 4.60
    assert counts.bound_s(counts.k1_bytes(8, 1000, 12, 32, RW, 5128, RW)) \
        == pytest.approx(1.374e-3, rel=1e-3)
    mean_uniq = 8 * 1000 * (1 - (1 - 1 / 1000) ** 1000)
    assert counts.k1_bytes(8, 1000, 12, 32, RW, round(mean_uniq), RW) \
        == pytest.approx(4.60e9, rel=0.006)


def test_k2_bytes_and_model_flops():
    # the kernel table's K2: 0.286 GB a call (int4, Mc=32, QFUSE rows)
    assert counts.k2_bytes(8, 1000, 768, 12, 32, 896, 2, True) / 1e9 \
        == pytest.approx(0.286, abs=0.0015)
    d = spec.load("configs", "ripor-t5base-32x256")["model"]
    # ~199 MFLOP a beam-step at t5-base
    assert counts.beam_step_flops(d, 16, 20) / 1e6 == pytest.approx(199,
                                                                   abs=1.5)


def test_live_beams():
    import numpy as np
    codes = np.array([[0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0]])
    assert counts.live_beams(codes, 2, 3, 3) == [1, 2, 3]
    assert counts.live_beams(codes, 2, 10, 3) == [1, 2, 3]
    rng = np.random.default_rng(0)
    big = rng.integers(0, 256, (5000, 12))
    assert counts.live_beams(big, 256, 4000, 12) == [1, 256, 4000] + [4000] * 9
