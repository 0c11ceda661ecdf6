"""BENCHMARK.json, the configurations and the cells, found by name."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def load(kind: str, name: str) -> dict:
    """portbench/<kind>/<name>.json: a configuration ("configs"), a cell
    ("workloads") or a traffic mix ("traffic": its driver and arrivals,
    its queries, the engine settings its clients get, the traced and the
    checked samples)."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise ValueError(f"no {kind} file for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no cell {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: end-to-end ones with
    ``trace`` off, per-layer ones with it on; each metric that lists
    cells only where it lists this one."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or name in m["workloads"]]


def problems(bench: dict) -> List[str]:
    """What in BENCHMARK.json and the files it names breaks the benchmark's
    rules of names, units and references (empty when none)."""
    out = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in bench[group]]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate names in {group}")
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        f = ROOT / c["file"]
        if not f.is_file() or HERE not in f.resolve().parents:
            out.append(f"config file {c['file']} missing or outside")
            continue
        conf = json.loads(f.read_text())
        if conf.get("source") != c["source"]:
            out.append(f"{c['name']}: source differs from its file")
        for k in c["reduced"]:
            if not NAME.match(k) or k not in conf.get("reduced", {}):
                out.append(f"{c['name']}: reduced key {k!r} not in its file")
    for w in bench["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        try:
            wl = load("workloads", w["name"])
        except (OSError, ValueError) as e:
            out.append(f"{w['name']}: {e}")
            continue
        if (wl.get("config"), wl.get("traffic"), wl.get("chips"),
                wl.get("why")) != (w["config"], w["traffic"], w["chips"],
                                   w["why"]):
            out.append(f"{w['name']}: file and entry disagree")
        try:
            mix = load("traffic", w["traffic"])
        except (OSError, ValueError) as e:
            out.append(f"{w['name']}: {e}")
            continue
        if not (HERE / "drivers"
                / f"{mix['arrivals']['driver']}.py").is_file():
            out.append(f"{w['name']}: no driver for {w['traffic']!r}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                           "higher"):
            out.append(f"{m['name']}: bad unit or direction")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: bad source {m['source']!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c!r}")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']!r}")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader")
        for c in m.get("workloads", cells):
            if m["moves"] not in {x["name"] for x in
                                  cell_metrics(bench, c, False)}:
                out.append(f"{m['name']}: {c} does not report {m['moves']}")
    for name in cells:
        rep = {x["name"] for x in cell_metrics(bench, name, False)}
        if "setup_s" not in rep or len(rep) < 2:
            out.append(f"{name}: needs setup_s and another end-to-end metric")
        if not cell_metrics(bench, name, True):
            out.append(f"{name}: no per-layer metric")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a pair of configuration and traffic appears twice")
    return out
