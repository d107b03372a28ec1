"""The port's command line: the .mps path to the LP solver, the .dat-s
path on the default (fused) driver, and an unknown extension."""

import json
import os
import subprocess
import sys

import pytest

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch.io.sdpa import write_sdpa
from hdsdp_tpu_torch.models import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANGED_MPS = """NAME          RANGED
ROWS
 N  COST
 L  R1
 G  R2
 E  R3
COLUMNS
    X1        COST      -1.0   R1   1.0
    X1        R2         1.0   R3   1.0
    X2        COST      -2.0   R1   1.0
    X2        R2        -1.0   R3   2.0
RHS
    RHS       R1         4.0   R2  -1.0
    RHS       R3         3.0
RANGES
    RNG       R1         2.0   R2   3.0
    RNG       R3         4.0
ENDATA
"""


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "hdsdp_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_cli_mps(tmp_path):
    path = tmp_path / "ranged.mps"
    path.write_text(RANGED_MPS)
    out = _cli(str(path), "--device", "cpu", "--json", "--quiet")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(summary) == {"status", "pObj", "dObj", "iters", "time_s", "device"}
    assert summary["status"] == "PRIMAL_DUAL_OPTIMAL" and summary["device"] == "cpu"
    assert summary["pObj"] == pytest.approx(-6.5, rel=1e-6)
    assert summary["dObj"] == pytest.approx(-6.5, rel=1e-6)


def test_cli_mps_prints_its_log(tmp_path):
    path = tmp_path / "ranged.mps"
    path.write_text(RANGED_MPS)
    out = _cli(str(path), "--device", "cpu", "--max-iter", "3")
    assert out.returncode == 1  # stopped at MAXITER
    assert "Optimizing an LP of" in out.stdout and "LP Status: MAXITER" in out.stdout


def test_cli_dat_s_default_path(tmp_path):
    path = tmp_path / "gpp12.dat-s"
    write_sdpa(tsyn.gpp_sdpa(n=12, seed=1), str(path))
    out = _cli(str(path), "--device", "cpu", "--json", "--quiet")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["status"] == "PRIMAL_DUAL_OPTIMAL" and summary["dimacs_max"] < 1e-6
    rj = JSolver(JProblem.from_sdpa(jsyn.gpp_sdpa(n=12, seed=1)), verbose=False).optimize()
    assert summary["dObj"] == pytest.approx(rj.d_obj, rel=1e-7)


def test_cli_unknown_extension(tmp_path):
    path = tmp_path / "problem.lp"
    path.write_text("min: x;\n")
    out = _cli(str(path), "--device", "cpu")
    assert out.returncode == 2 and "unrecognized extension" in out.stderr
