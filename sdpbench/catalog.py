"""Finds a cell's parts by the names that ``BENCHMARK.json`` gives.

  - a configuration: ``configs/<name>.json`` (its sizes, its generator, the
    solver's options, the limits of the check);
  - a traffic mix: ``traffic/<name>.json`` (the parameters that
    ``sdpbench.traffic`` reads);
  - a generator: ``generators/<name>.py`` (``generate(seed, **args)``);
  - a metric: ``metrics/<name>.py`` (``read(record)``, and ``SPANS``: the
    functions of the program it needs wrapped in a traced run).

Each is looked up in the benchmark's directory, or in the directories a
caller puts before it (the tests add their own).  Nothing here imports the
program.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _find(kind: str, name: str, suffix: str, dirs: Sequence[Path]) -> Path:
    for d in list(dirs) + [HERE]:
        p = Path(d) / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} in {[str(d) for d in dirs] + [str(HERE)]}")


def _json(kind, name, dirs):
    with open(_find(kind, name, ".json", dirs)) as f:
        return json.load(f)


def config(name: str, dirs: Sequence[Path] = ()) -> dict:
    return _json("configs", name, dirs)


def traffic(name: str, dirs: Sequence[Path] = ()) -> dict:
    return _json("traffic", name, dirs)


def _module(kind: str, name: str, dirs):
    path = _find(kind, name, ".py", dirs)
    spec = importlib.util.spec_from_file_location(f"sdpbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str, dirs: Sequence[Path] = ()):
    return _module("generators", name, dirs)


def metric(name: str, dirs: Sequence[Path] = ()):
    return _module("metrics", name, dirs)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]
