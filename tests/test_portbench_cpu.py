"""The benchmark's CPU tests (``portbench/tests/``), collected with the
rest of ``tests/``: its files, its control, its fault cases, the plain
reference model and the toy rehearsal. The ``cuda`` cases skip without a
card."""
import importlib
from pathlib import Path

from portbench.tests.test_bench_files import *  # noqa: F401,F403
from portbench.tests.test_control import *  # noqa: F401,F403
from portbench.tests.test_faults import *  # noqa: F401,F403
from portbench.tests.test_reference_model import *  # noqa: F401,F403
from portbench.tests.test_rehearsal import *  # noqa: F401,F403

PORTBENCH_TESTS = Path(__file__).resolve().parent.parent / "portbench" / "tests"


def test_every_portbench_test_is_collected_here():
    """A module under ``portbench/tests/`` left out of the imports above, a
    test name that two modules share (the later import would hide the
    earlier test) or a module-wide ``pytestmark`` (it would mark every test
    here) fails this test instead of dropping tests without a word."""
    here = globals()
    modules = sorted(PORTBENCH_TESTS.glob("test_*.py"))
    assert modules
    for path in modules:
        module = importlib.import_module(f"portbench.tests.{path.stem}")
        assert not hasattr(module, "pytestmark"), path.name
        for name, obj in vars(module).items():
            if name.startswith(("test", "Test")):
                assert here.get(name) is obj, f"{path.name}::{name}"
