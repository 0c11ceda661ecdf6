"""The multi-hour ``nightly`` proof runs only when ``-m`` names it: the
root ``conftest.py`` deselects it under any other selection, including a
command-line ``-m`` that replaces pyproject's ``addopts``."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PROOF = "tests/test_full_recipe.py::test_curriculum_proof_nightly"
ARTIFACT = "tests/test_full_recipe.py::test_fullscale_proof_artifact"


def collected(*marks):
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_full_recipe.py",
         "--collect-only", "-q", "-p", "no:cacheprovider", *marks],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return {line.strip() for line in p.stdout.splitlines() if "::" in line}


@pytest.mark.parametrize("marks,proof", [
    (("-m", "not slow"), False),
    (("-m", "nightly"), True),
    ((), False),
], ids=["not-slow", "nightly", "no-m"])
def test_nightly_runs_only_when_named(marks, proof):
    ids = collected(*marks)
    assert (PROOF in ids) == proof
    assert (ARTIFACT in ids) == (not proof)
