"""The benchmark's own tests: ``python -m pytest sdpbench/tests -q`` from the
repository root (about a minute on the host); ``-m cuda`` runs those that
need the card, which skip without one."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"

# cells made of the test-only files under data/
TEST_CELLS = [
    {"name": "tiny_maxcut.solo", "config": "tiny_maxcut", "traffic": "tiny_solo", "chips": 1,
     "why": "test cell"},
    {"name": "tiny_theta.solo", "config": "tiny_theta", "traffic": "tiny_solo", "chips": 1,
     "why": "test cell"},
    {"name": "tiny_maxcut.fleet", "config": "tiny_maxcut", "traffic": "tiny_fleet", "chips": 1,
     "why": "test cell"},
]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips where none is available)")


@pytest.fixture
def bench():
    """BENCHMARK.json with the test cells and the test metric added."""
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    names = [c["name"] for c in TEST_CELLS]
    b["workloads"] += [dict(c) for c in TEST_CELLS]
    for m in b["per_layer"]:
        m["workloads"] = m["workloads"] + names
    b["per_layer"].append({"name": "tiny_calls", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "IPM driver",
                           "moves": "solve_s", "workloads": names})
    return b


@pytest.fixture
def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
