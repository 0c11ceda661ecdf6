"""run.py's plumbing on the CPU at the toy size, through the kernels'
plain versions; the measured path refuses to run without a card."""
import json
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.spec import ROOT
from portbench.tests.toy import run_toy

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_at_the_toy_size(cell, trace):
    r = run_toy(cell, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    want = {m["name"] for m in spec.cell_metrics(spec.load_benchmark(),
                                                  cell, trace)}
    assert set(r["metrics"]) <= want
    if not trace:
        # the end-to-end metrics are read from the host clock
        assert set(r["metrics"]) == want
    else:
        # the CPU has no device trace; what the program counts is read
        assert "sample" not in r["metrics"]
        assert {"device_ops", "idle_gaps"} <= set(r["breakdown"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_only_the_benchmark_in_the_checkout(tmp_path):
    """A checkout that holds BENCHMARK.json and portbench/ alone: no
    result."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_after(body):
    p = subprocess.run([sys.executable, "-c", IMPORTS.format(
        root=str(ROOT), body=body)], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Top-level names compared whole: ripor_tpu_torch is not ripor_tpu."""
    top = loaded_after("from portbench.tests.toy import run_toy\n"
                       "run_toy('t5base-32x256-offline-b1000', trace=True)")
    assert "ripor_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import portbench.reference")
    assert not top & {"ripor_tpu_torch", *run.FORBIDDEN}
