"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every configuration, traffic mix and metric is a file of its own, and a
cell made only of added files runs."""

import json
import re

import pytest

from sdpbench import catalog, harness
from sdpbench.tests.conftest import DATA, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["sdpbench"] and 1 <= b["run_seconds"] <= 51
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("sdpbench/") and (ROOT / c["file"]).is_file()
        assert catalog.config(c["name"])["reduced"] == c["reduced"] == []
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        catalog.traffic(w["traffic"])
    assert {c for c in cfgs} == {w["config"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(cells)
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        rd = catalog.metric(m["name"])
        assert callable(rd.read) and isinstance(rd.SPANS, dict)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for w in cells:
        assert catalog.metrics_of(b, w, traced=True), w
        assert "setup_s" in {m["name"] for m in catalog.metrics_of(b, w, traced=False)}
    # each per-layer metric's spans resolve to functions of the program
    from sdpbench import tracing

    for m in b["per_layer"]:
        for target in catalog.metric(m["name"]).SPANS.values():
            owner, attr = tracing.resolve(target)
            assert callable(getattr(owner, attr))


def test_lookup_by_name_prefers_added_directories():
    assert catalog.config("tiny_maxcut", [DATA])["args"]["n"] == 24
    assert catalog.traffic("tiny_fleet", [DATA])["fleet"] == 4
    assert catalog.metric("tiny_calls", [DATA]).read is not None
    assert catalog.config("maxG51", [DATA])["args"]["n_edges"] == 5909  # falls through
    with pytest.raises(FileNotFoundError):
        catalog.config("tiny_maxcut")  # test files are not the benchmark's


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_of_added_files_runs(bench, trace):
    r = harness.run_cell("tiny_maxcut.solo", 2 ** 31 + 7, 0.5, bool(trace), device="cpu",
                         bench=bench, dirs=[DATA])
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "check"
    if trace:
        assert r["metrics"]["tiny_calls"]["value"] >= 1
        assert r["metrics"]["iters_per_solve"]["value"] > 5
        assert "solve_s" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"solve_s", "setup_s"}  # no device, no peak
