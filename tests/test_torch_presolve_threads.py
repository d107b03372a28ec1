"""The port's presolve gives the same bits at any CPU thread count.

theta6 (``theta_sdpa(n=300, n_edges=4374, seed=0)``) and gpp500
(``gpp_sdpa(n=500, seed=0)``) are presolved in subprocesses whose BLAS/OpenMP thread count is set by the environment;
every ndarray of the resulting ``SDPProblem`` (groups, coefficient
analyses, LP part, features) is compared bitwise with the
single-threaded run.  Before the low-rank detection pinned its
eigendecomposition to one BLAS thread, the C block's rank-1 factor
differed at 1e-13 between 1, 2 and 8 threads (threaded OpenBLAS).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# prints one "<field path> <sha256 of dtype, shape and bytes>" line per array
DIGEST = r"""
import dataclasses, hashlib, sys
import numpy as np
from hdsdp_tpu_torch.models import synthetic
from hdsdp_tpu_torch.models.problem import SDPProblem

CALLS = {
    "theta6": lambda: synthetic.theta_sdpa(n=300, n_edges=4374, seed=0),
    "gpp500": lambda: synthetic.gpp_sdpa(n=500, seed=0),
}
prob = SDPProblem.from_sdpa(CALLS[sys.argv[1]]())

def walk(path, x):
    if isinstance(x, np.ndarray):
        h = hashlib.sha256(str((x.dtype.str, x.shape)).encode() + x.tobytes()).hexdigest()
        print(path, h)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            walk(path + "." + f.name, getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            walk(f"{path}[{i}]", v)
    elif isinstance(x, dict):
        for k in sorted(x):
            walk(f"{path}[{k!r}]", x[k])
    elif isinstance(x, (int, float, bool, str)) or x is None:
        print(path, repr(x))

walk("prob", prob)
"""


def _digest(name: str, threads: int) -> dict:
    env = dict(os.environ)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = str(threads)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", DIGEST, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln.split(" ", 1) for ln in out.stdout.splitlines() if ln.strip()]
    return dict(lines)


@pytest.fixture(scope="module")
def one_thread():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _digest(name, 1)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["theta6", "gpp500"])
@pytest.mark.parametrize("threads", [1, 2, 8])
def test_presolve_bits_do_not_depend_on_threads(one_thread, name, threads):
    want = one_thread(name)
    got = _digest(name, threads)
    assert sorted(got) == sorted(want)
    differ = [k for k in want if got[k] != want[k]]
    assert not differ, f"{name}: {threads} threads change {differ}"
    # the C block's factors, where the fault showed, are among those compared
    assert any(k.startswith("prob.block_infos[0][0].") for k in got)
