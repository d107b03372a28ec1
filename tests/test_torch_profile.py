"""The port's profiling utilities (utils/profile.py) on CPU tensors: the
program's tracer (spans, counters, recording) on its own and around tiny
solves, the timing helpers and the LP solver's phase counters."""

import collections
import json
import os
import time

import numpy as np
import pytest
import torch

from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.models.synthetic import maxcut_sdpa
from hdsdp_tpu_torch.solver import fused
from hdsdp_tpu_torch.solver.batch import solve_batch
from hdsdp_tpu_torch.solver.solver import HDSDPSolver
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.profile import PhaseStats, profile_fn, synchronize, trace


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_recorder_nests_spans_under_one_root():
    with profile.recording() as rec:
        with profile.span("solve"):
            with profile.span("iter"):
                with profile.span("ratio_test"):
                    profile.count("ratio_tests")
                profile.count("host_reads", 3)
            with profile.span("iter"):
                pass
        with profile.span("get_primal"):
            pass
    assert [s.name for s in rec.spans] == ["ratio_test", "iter", "iter", "solve", "get_primal"]
    solve = next(s for s in rec.spans if s.name == "solve")
    first, second = (s for s in rec.spans if s.name == "iter")
    ratio = next(s for s in rec.spans if s.name == "ratio_test")
    assert solve.parent is None and solve.root == solve.id
    assert first.parent == second.parent == solve.id and ratio.parent == first.id
    assert {first.root, second.root, ratio.root} == {solve.id}
    other = next(s for s in rec.spans if s.name == "get_primal")
    assert other.parent is None and other.root == other.id != solve.id
    assert len({s.id for s in rec.spans}) == 5
    assert solve.t0 <= first.t0 <= ratio.t0 <= ratio.t1 <= first.t1 <= second.t0 <= solve.t1
    assert rec.counters == {"ratio_tests": 1, "host_reads": 3}


def test_recorder_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or torch.autograd.profiler.record_function(name))
    assert profile.span("a") is profile.span("b")  # one shared no-op
    with profile.span("a"):
        profile.count("host_reads")
    assert opened == []
    with profile.recording() as rec:
        with profile.span("a"):
            profile.count("host_reads")
    assert opened == ["hdsdp/a"] and rec.counters == {"host_reads": 1}
    with profile.span("a"):  # off again: the closed recording is left as it was
        profile.count("host_reads")
    assert len(rec.spans) == 1 and rec.counters == {"host_reads": 1} and opened == ["hdsdp/a"]
    with profile.recording():
        with pytest.raises(RuntimeError):
            with profile.recording():
                pass


def test_recorder_closes_a_span_whose_block_raises():
    with profile.recording() as rec:
        with pytest.raises(KeyError):
            with profile.span("outer"):
                with profile.span("bad"):
                    raise KeyError("x")
        with profile.span("after"):
            pass
    assert [s.name for s in rec.spans] == ["bad", "outer", "after"]
    assert rec.spans[0].parent == rec.spans[1].id and rec.spans[2].parent is None


def test_spans_are_on_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile.recording():
            with profile.span("solve"):
                torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "hdsdp/solve" in names


def _counted_ratio_calls(monkeypatch):
    calls = []
    inner = fused.cone_ratio

    def wrapped(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(fused, "cone_ratio", wrapped)
    return calls


def test_traced_solo_solve(one_thread, monkeypatch):
    """The fused "iter" driver, as the benchmark's solo cells run it."""
    data = maxcut_sdpa(n=24, seed=5)

    def solve():
        s = HDSDPSolver(SDPProblem.from_sdpa(data), device="cpu", verbose=False, fused="iter")
        r = s.optimize()
        s.get_primal()
        return r

    off = solve()
    calls = _counted_ratio_calls(monkeypatch)
    with profile.recording() as rec:
        on = solve()
    names = collections.Counter(s.name for s in rec.spans)
    assert on.stats["fused"] == "iter" and on.status == "PRIMAL_DUAL_OPTIMAL"
    assert names["iter"] == on.n_iters and names["solve"] == 1
    assert names["presolve"] == names["analyze"] == 1 and names["dimacs"] == 1
    assert names["ipm_setup"] >= 1 and names["get_primal"] == 1
    assert rec.counters["ratio_tests"] == len(calls) == names["ratio_test"] > on.n_iters
    assert rec.counters["host_reads"] >= on.stats["fused_host_reads"]
    solve_id = next(s.id for s in rec.spans if s.name == "solve")
    assert all(s.root == solve_id for s in rec.spans if s.name in ("iter", "ratio_test"))
    assert np.array_equal(on.y, off.y) and on.y.dtype == off.y.dtype
    assert (on.p_obj, on.d_obj, on.n_iters) == (off.p_obj, off.d_obj, off.n_iters)


def test_sinv_span_and_count_per_chol_inverse(one_thread, monkeypatch):
    """Every ``chol_inverse`` call counts one ``sinv`` and records one
    ``sinv`` span under a recording, and nothing without one."""
    from hdsdp_tpu_torch.ops import chol as chol_ops

    data = maxcut_sdpa(n=24, seed=3)
    calls = []
    inner = chol_ops.chol_inverse

    def wrapped(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(chol_ops, "chol_inverse", wrapped)

    def solve():
        s = HDSDPSolver(SDPProblem.from_sdpa(data), device="cpu", verbose=False, fused="iter")
        r = s.optimize()
        s.get_primal()
        return r

    with profile.recording() as rec:
        on = solve()
    sinv = [s for s in rec.spans if s.name == "sinv"]
    assert on.status == "PRIMAL_DUAL_OPTIMAL" and len(calls) > on.n_iters
    assert rec.counters["sinv"] == len(calls) == len(sinv)
    by_id = {s.id: s.name for s in rec.spans}
    assert {by_id[s.parent] for s in sinv} <= {"build_kkt", "dimacs", "get_primal"}
    assert all(s.t0 <= s.t1 for s in sinv)
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or torch.autograd.profiler.record_function(name))
    calls.clear()
    off = solve()
    assert len(calls) == len(sinv) and opened == []
    assert rec.counters["sinv"] == len(sinv)  # the closed recording is left as it was
    assert np.array_equal(on.y, off.y) and on.n_iters == off.n_iters


def test_traced_fleet_of_two(one_thread, monkeypatch):
    probs = [SDPProblem.from_sdpa(maxcut_sdpa(n=24, seed=s)) for s in (1, 2)]
    off = solve_batch(probs, device="cpu")
    calls = _counted_ratio_calls(monkeypatch)
    with profile.recording() as rec:
        on = solve_batch(probs, device="cpu")
    names = collections.Counter(s.name for s in rec.spans)
    fleet = on[0].stats["fleet"]
    assert all(r.stats["batch_solo"] == 0 for r in on) and fleet["size"] == 2
    assert names["iter"] == fleet["iterations"] and names["solve"] == 1
    assert rec.counters["ratio_tests"] == len(calls) == names["ratio_test"]
    assert rec.counters["host_reads"] >= on[0].stats["fused_host_reads"]
    for a, b in zip(on, off):
        assert np.array_equal(a.y, b.y)
        assert (a.p_obj, a.d_obj, a.n_iters) == (b.p_obj, b.d_obj, b.n_iters)


def test_profile_fn_times_and_calls():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.001)
        return {"out": (x @ x, [x.sum()])}

    x = torch.ones((16, 16), dtype=torch.float64)
    dt = profile_fn(fn, x, n=4)
    assert len(calls) == 5  # one warm-up call and n timed
    assert 0.001 <= dt < 1.0
    synchronize({"a": [x], "b": (x, 3)})  # nests of CPU tensors: nothing to wait for


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn((64, 64), dtype=torch.float64)
    with trace(log_dir) as prof:
        (x @ x).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert prof is not None


def test_phase_stats_ratio():
    st = PhaseStats()
    assert st.factor_solve_ratio == float("inf")
    st.factor_s, st.solve_s = 3.0, 0.5
    assert st.factor_solve_ratio == 6.0
    assert st.extra == {} and PhaseStats().extra is not st.extra


@pytest.mark.cuda
def test_host_reads_match_the_syncs_cuda_reports():
    """On the card, a fused "iter" solve (Lanczos ratio tests, n >= 192) and
    a fleet of 2: in every function, the device-to-host syncs that
    ``torch.cuda.set_sync_debug_mode`` reports equal the ``host_reads``
    counted there (``tests/sync_reads_check.py``; the copies from the host
    that it lists also sync, and are not reads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "sync_reads_check", os.path.join(os.path.dirname(__file__), "sync_reads_check.py"))
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    probs = [SDPProblem.from_sdpa(maxcut_sdpa(n=200, seed=s)) for s in (1, 2)]

    def solo():
        s = HDSDPSolver(probs[0], device="cuda", verbose=False, fused="iter")
        assert s.optimize().status == "PRIMAL_DUAL_OPTIMAL"
        s.get_primal()

    def fleet():
        assert all(r.stats["batch_solo"] == 0 for r in solve_batch(probs, device="cuda"))

    for fn in (solo, fleet):
        fn()  # warm
        warned, h2d, counted, lines, total = check.measured(fn)
        assert total > 0 and total == sum(counted.values()) == sum(warned.values())
        assert check.differences(warned, h2d, counted, lines, total) == []
