"""The fused bodies check the interior as often as the JAX package's.

control11 made 380 interior checks in 32 fused iterations on the card.
Here a small control instance (``control_sdpa(k=10, n_sys=2, seed=0)``) is
solved on the CPU by the JAX package's fused programs, run op by op under
``jax.disable_jit()`` so that every ``check_interior`` call is a Python
call, and by the port's fused bodies; a counter wrapped around each
package's ``check_interior`` (from this test, not in the packages) counts
the calls per phase (``ipm.which_method``).  Both give 1 in phase A and
379 in phase B over 30 iterations."""

import collections

import jax
import pytest

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver import algo as jalgo
from hdsdp_tpu.solver import fused as jfused
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.solver import algo as talgo
from hdsdp_tpu_torch.solver import fused as tfused
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver

KW = dict(k=10, n_sys=2, seed=0)


def _count(monkeypatch, fused_mod, algo_mod):
    """Counter of check_interior calls by the phase that made them."""
    counts = collections.Counter()
    held = {}
    check, solve = fused_mod.check_interior, algo_mod.DualIPM.solve

    def counted_check(*args, **kwargs):
        counts[held["ipm"].which_method] += 1
        return check(*args, **kwargs)

    def holding_solve(self, *args, **kwargs):
        held["ipm"] = self
        return solve(self, *args, **kwargs)

    monkeypatch.setattr(fused_mod, "check_interior", counted_check)
    monkeypatch.setattr(algo_mod.DualIPM, "solve", holding_solve)
    return counts


@pytest.fixture(scope="module")
def counts():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        cj = _count(mp, jfused, jalgo)
        with jax.disable_jit():
            rj = JSolver(JProblem.from_sdpa(jsyn.control_sdpa(**KW)), verbose=False,
                         fused="iter").optimize()
        out["jax"] = (rj, dict(cj))
    with pytest.MonkeyPatch.context() as mp:
        ct = _count(mp, tfused, talgo)
        rt = TSolver(TProblem.from_sdpa(tsyn.control_sdpa(**KW)), device="cpu",
                     verbose=False, fused="iter").optimize()
        out["torch"] = (rt, dict(ct))
    return out


def test_interior_checks_per_phase_agree(counts):
    (rj, cj), (rt, ct) = counts["jax"], counts["torch"]
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.n_iters == rj.n_iters
    assert ct == cj
    assert cj == {"infeas": 1, "potential": 379}


def test_the_port_ran_its_fused_bodies(counts):
    rt, _ = counts["torch"]
    assert rt.stats["fused"] == "iter" and rt.stats["fused_host_reads"] > 0
