"""The lower-precision control comes out not correct, where sound runs of
the same cells come out correct (tiny sizes on the host; on the card the
same comparison runs at the cells' own sizes: ``python3 -m
sdpbench.control``)."""

import pytest

from sdpbench import control, harness
from sdpbench.tests.conftest import DATA

CELLS = ["tiny_maxcut.solo", "tiny_theta.solo", "tiny_maxcut.fleet"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_float32_reference_is_refused(bench, workload):
    r = control.control(workload, 21, "reference32", device="cpu", bench=bench, dirs=[DATA])
    assert not r["correct"]
    # it fails on a number, not only on the status it reports
    assert any(v["value"] > v["limit"] for k, v in r["numbers"].items() if k != "bad_status")


def test_the_programs_float32_path_is_refused_on_theta(bench):
    r = control.control("tiny_theta.solo", 21, "program32", device="cpu", bench=bench,
                        dirs=[DATA])
    assert not r["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(bench, workload):
    r = harness.run_cell(workload, 21, 0.3, False, device="cpu", bench=bench, dirs=[DATA])
    assert r["correct"] and r["failed"] == 0
