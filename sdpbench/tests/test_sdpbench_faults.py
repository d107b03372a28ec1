"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a cell of this benchmark can have (there is no
exchange between chips: every cell takes one)."""

import numpy as np
import pytest

from hdsdp_tpu_torch.solver import batch, fused
from hdsdp_tpu_torch.solver.solver import HDSDPSolver
from sdpbench import harness
from sdpbench.tests.conftest import DATA

CELLS = ["tiny_maxcut.solo", "tiny_theta.solo", "tiny_maxcut.fleet"]


def _run(bench, workload):
    return harness.run_cell(workload, 5, 0.3, False, device="cpu", bench=bench, dirs=[DATA])


def _unchanged(c, p, st_ex, *a):
    """Phase B's step returning its iterate unchanged; only the iteration
    count moves, so that the loop ends at max_iter instead of never."""
    st = st_ex[0]
    return (st._replace(n_iter=st.n_iter + 1),) + tuple(st_ex[1:])


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(bench, workload, monkeypatch):
    monkeypatch.setattr(fused, "_phase_b_iteration", _unchanged)
    r = _run(bench, workload)
    assert not r["correct"] and r["failed"] == r["attempted"]


def test_half_of_the_fleet_left_out(bench, monkeypatch):
    real = batch.solve_batch

    def half(probs, **kw):
        rs = real(probs[: len(probs) // 2], **kw)
        return rs + rs  # the first half's answers stand for the rest

    monkeypatch.setattr(batch, "solve_batch", half)
    r = _run(bench, "tiny_maxcut.fleet")
    assert not r["correct"] and r["check"]["dimacs_max"]["value"] > 1e-3


def _alter(y):
    y = np.array(y, copy=True)
    y[0] += 1e-4 * (1.0 + abs(y[0]))
    return y


@pytest.mark.parametrize("workload", CELLS[:2])
def test_an_answer_altered_where_it_is_produced(bench, workload, monkeypatch):
    real = HDSDPSolver.optimize

    def altered(self, *a, **kw):
        r = real(self, *a, **kw)
        r.y = _alter(r.y)
        return r

    monkeypatch.setattr(HDSDPSolver, "optimize", altered)
    r = _run(bench, workload)
    assert not r["correct"]


def test_a_fleet_answer_altered_where_it_is_produced(bench, monkeypatch):
    real = batch.solve_batch

    def altered(probs, **kw):
        rs = real(probs, **kw)
        rs[-1].y = _alter(rs[-1].y)
        return rs

    monkeypatch.setattr(batch, "solve_batch", altered)
    r = _run(bench, "tiny_maxcut.fleet")
    assert not r["correct"]


def test_a_fleet_answer_feasible_but_not_optimal(bench, monkeypatch):
    """A member's y lowered: still dual feasible (the slack C - diag(y)
    grows), with the objectives reported as before; only b'y of the y
    returned shows it."""
    real = batch.solve_batch

    def lowered(probs, **kw):
        rs = real(probs, **kw)
        rs[-1].y = np.asarray(rs[-1].y) - 1e-3 * (1.0 + np.abs(np.asarray(rs[-1].y)).max())
        return rs

    monkeypatch.setattr(batch, "solve_batch", lowered)
    r = _run(bench, "tiny_maxcut.fleet")
    assert not r["correct"] and r["check"]["dimacs_max"]["value"] > 1e-5
