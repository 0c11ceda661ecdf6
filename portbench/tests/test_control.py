"""The control: the reference in float8 in the program's place fails the
check's numbers, run as portbench/readings.py runs it (at the toy size
here; on the card at each cell's own size, for the limits)."""
import pytest

from portbench.check import judge, numbers
from portbench.tests.toy import TOY_LIMITS, run_toy


@pytest.mark.parametrize("cell", ["t5base-32x256-offline-b1000",
                                  "t5base-32x256-serve-b100",
                                  "t5base-32x256-offline-b1000-bf16"])
def test_control_fails_and_program_passes(cell):
    r = run_toy(cell, seed=99, control=True)
    program, control = numbers(r["compared"]), numbers(r["control"])
    assert judge(program, TOY_LIMITS)
    assert not judge(control, TOY_LIMITS)
    assert control["score_gap_median"] > 2 * program["score_gap_median"]
    assert ([d.shape for d in r["compared"]["diffs"]]
            == [d.shape for d in r["control"]["diffs"]])
