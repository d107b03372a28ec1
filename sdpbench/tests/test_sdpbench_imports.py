"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the plain reference imports nothing of the program."""

import subprocess
import sys

from sdpbench.tests.conftest import ROOT

GUARD = "jax jaxlib flax hdsdp_tpu".split()


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    code = ("import json\n"
            "from sdpbench import harness, run, control\n"
            "from sdpbench.tests.conftest import DATA, TEST_CELLS\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "b['workloads'] += TEST_CELLS\n"
            "for m in b['per_layer']: m['workloads'] += [c['name'] for c in TEST_CELLS]\n"
            "assert harness.run_cell('tiny_theta.solo', 3, 0.3, True, device='cpu', bench=b,"
            " dirs=[DATA])['correct']\n"
            "assert harness.forbidden_modules() == []\n")
    names = _loaded(code)
    assert "hdsdp_tpu_torch" in names  # the port was run
    assert not names & set(GUARD)


def test_the_reference_imports_nothing_of_the_program():
    names = _loaded("import sdpbench.reference, sdpbench.check, sdpbench.sdpa\n"
                    "import sdpbench.generators.maxcut, sdpbench.generators.theta\n")
    assert not names & set(GUARD + ["hdsdp_tpu_torch"])
    for f in ("reference.py", "check.py", "sdpa.py", "generators/maxcut.py", "generators/theta.py"):
        src = (ROOT / "sdpbench" / f).read_text()
        assert "import hdsdp" not in src and "from hdsdp" not in src


def test_the_guard_compares_whole_names(monkeypatch):
    from sdpbench import harness

    monkeypatch.setitem(sys.modules, "hdsdp_tpu_torchlike", sys)
    assert "hdsdp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hdsdp_tpu", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["hdsdp_tpu", "jax"]
