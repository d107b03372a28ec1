"""A run with no card, or with fewer than the cell asks for, fails and prints
no result; so does a run in a directory that holds only the benchmark."""

import shutil
import subprocess
import sys

import pytest

from sdpbench.tests.conftest import ROOT

ARGS = ["-m", "sdpbench.run", "--workload", "maxG51.solo", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable] + ARGS, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "sdpbench", tmp_path / "sdpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from sdpbench import harness\n"
            "from sdpbench.tests.conftest import DATA, TEST_CELLS\n"
            "import json\n"
            "b = json.load(open('BENCHMARK.json')); b['workloads'] += TEST_CELLS\n"
            "print(harness.run_cell('tiny_maxcut.solo', 1, 0.2, False, device='cpu', bench=b,"
            " dirs=[DATA]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "hdsdp_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
    out = subprocess.run([sys.executable] + ARGS, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_test_cell_on_the_card(bench, need_card):
    from sdpbench import harness
    from sdpbench.tests.conftest import DATA

    r = harness.run_cell("tiny_maxcut.fleet", 11, 1.0, True, device="cuda", bench=bench,
                         dirs=[DATA])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert r["metrics"]["launches_per_iter"]["value"] > 0
