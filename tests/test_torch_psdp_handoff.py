"""PSDP's hand-off from the port's fused phase B, carried to the JAX
package's refiner.

The port solves a theta instance (one cone, n < m/3) on its default path;
a spy on its ``PSDPRefiner.optimize`` saves the iterate it hands off
(checkpoint format, with the objectives the refiner starts from) and
records the port's refinement.  The JAX package's ``PSDPRefiner`` then
starts from that iterate.  It must exit at the same refinement step with
the same flag (one failing case may give up one step apart, see
INSTANCES).  (The reverse direction, the JAX iterate into the port's
refiner, is tests/test_torch_psdp.py.)"""

import jax.numpy as jnp
import pytest

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver import algo as jalgo
from hdsdp_tpu.solver import psdp as jpsdp
from hdsdp_tpu.solver.params import Params as JParams
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.solver import psdp as tpsdp
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver
from hdsdp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

INSTANCES = {
    # name: (theta_sdpa kwargs, the refiner returns a primal, steps may differ by)
    "theta30": (dict(n=30, n_edges=250, seed=0), True, 0),
    "theta60": (dict(n=60, n_edges=400, seed=0), False, 0),
    # a failing refinement walks into a nearly singular X, whose late
    # iterates differ between LAPACK builds (test_torch_psdp.py): here the
    # two refiners give up one step apart (23 and 24), with the same flag
    "theta40": (dict(n=40, n_edges=300, seed=1), False, 1),
}


def _jax_ipm_at(kw, ck, before):
    """A JAX DualIPM set to the port's hand-off iterate."""
    ipm = jalgo.DualIPM(JProblem.from_sdpa(jsyn.theta_sdpa(**kw)), JParams(verbose=False))
    ipm.y = jnp.asarray(ck["y"])
    ipm.tau, ipm.Rd, ipm.mu = float(ck["tau"]), float(ck["rd"]), float(ck["mu"])
    ipm.perturb, ipm.n_iter = float(ck["perturb"]), int(ck["n_iter"])
    ipm.status = str(ck["status"])
    for name in ("acc", "inacc"):
        if ck[f"maker_{name}_y"].size:
            setattr(ipm, f"maker_{name}", jalgo.Maker(
                mu=float(ck[f"maker_{name}_mu"]), y=jnp.asarray(ck[f"maker_{name}_y"]),
                dy=jnp.asarray(ck[f"maker_{name}_dy"])))
    ipm.which_method = "potential"
    for k, v in before.items():
        setattr(ipm, k, float(v))
    return ipm


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_jax_refiner_exits_where_the_port_did(name, tmp_path, monkeypatch):
    kw, returns_primal, step_slack = INSTANCES[name]
    path = str(tmp_path / "handoff.npz")
    snap = {}
    orig = tpsdp.PSDPRefiner.optimize

    def spy(self):
        if "ret" in snap:
            return orig(self)
        ipm = self.ipm
        save_checkpoint(path, ipm)
        snap["before"] = dict(comp=ipm.comp, p_obj_val=ipm.p_obj_val,
                              d_obj_val=ipm.d_obj_val, p_obj_internal=ipm.p_obj_internal,
                              d_obj_internal=ipm.d_obj_internal)
        ret = orig(self)
        snap.update(ret=ret, steps=self.n_iter, d_obj=ipm.d_obj_val)
        return ret

    monkeypatch.setattr(tpsdp.PSDPRefiner, "optimize", spy)
    r = TSolver(TProblem.from_sdpa(tsyn.theta_sdpa(**kw)), device="cpu",
                verbose=False).optimize()
    monkeypatch.undo()
    assert r.status == "PRIMAL_DUAL_OPTIMAL" and r.stats["fused"] == "phase"
    assert "ret" in snap, "the port's fused phase B never handed off to PSDP"

    ipm = _jax_ipm_at(kw, load_checkpoint(path), snap["before"])
    assert ipm.check_is_interior(1.0, ipm.y)
    n0 = ipm.n_iter
    ret = jpsdp.PSDPRefiner(ipm).optimize()
    assert ret == snap["ret"] == returns_primal
    assert abs((ipm.n_iter - n0) - snap["steps"]) <= step_slack
    assert ipm.d_obj_val == pytest.approx(snap["d_obj"], rel=1e-7)
