"""The port's profiling utilities (utils/profile.py) on CPU tensors."""

import json
import os
import time

import pytest
import torch

from hdsdp_tpu_torch.utils.profile import PhaseStats, Region, profile_fn, synchronize, trace


def test_region_accumulates():
    reg = Region()
    for _ in range(3):
        with reg("a"):
            time.sleep(0.002)
    with reg("b"):
        pass
    assert reg.count["a"] == 3 and reg.count["b"] == 1
    assert reg.total["a"] >= 0.006 and reg.total["a"] > reg.total["b"]
    lines = reg.report().splitlines()
    assert lines[0].startswith("a") and "x3" in lines[0]


def test_region_counts_a_raising_block():
    reg = Region()
    with pytest.raises(KeyError):
        with reg("bad"):
            raise KeyError("x")
    assert reg.count["bad"] == 1


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
