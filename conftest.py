"""Test selection and worker threads for every test under the rootdir.

``pyproject.toml`` keeps the multi-hour ``nightly`` proof out of plain runs
with ``addopts = "-m 'not nightly'"``. A ``-m`` given on the command line
replaces that one, so ``pytest tests/ -m 'not slow'`` would start the proof
too. The hook below deselects ``nightly`` tests under any ``-m`` expression
that does not name the marker; ``pytest tests/ -m nightly`` still runs the
proof.

Under pytest-xdist each worker is a process of its own, and torch's OpenMP
pool takes one thread per core in each of them: six workers on eight cores
spin dozens of threads against each other and against XLA's. Each worker
gets its share of the cores the process may run on (its affinity, not the
host's count) instead, unless ``OMP_NUM_THREADS`` is set.

The file loads before ``tests/conftest.py`` and imports nothing heavy.
"""
import os
import re

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    os.environ.setdefault("OMP_NUM_THREADS", str(max(
        1, len(os.sched_getaffinity(0))
        // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))))


def pytest_collection_modifyitems(config, items):
    if re.search(r"\bnightly\b", config.option.markexpr or ""):
        return
    nightly = [item for item in items if item.get_closest_marker("nightly")]
    if nightly:
        config.hook.pytest_deselected(items=nightly)
        items[:] = [item for item in items if item not in nightly]
