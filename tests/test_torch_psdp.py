"""The port's PSDP primal refinement (solver.psdp) against the JAX
package's on identical inputs: the helpers on shared numpy arrays, and
``PSDPRefiner.optimize()`` started in both packages from one JAX iterate.

The JAX host loop runs until phase B calls its refiner; the state at that
call (iterate and makers, through the checkpoint format) is loaded into the
port, which then runs its own refiner.  The refinement walks into nearly
singular X, where late iterates differ between LAPACK builds; what is held
is the return flag, the iteration count (+-1), the objectives (1e-7) and,
where both refiners return a primal, the symmetric part of X (1e-5 of its
largest entry, after 14-17 iterations of that walk)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.ops import chol as jchol
from hdsdp_tpu.solver import cones as jcones
from hdsdp_tpu.solver import psdp as jpsdp
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.ops import chol as tchol
from hdsdp_tpu_torch.solver import algo as talgo
from hdsdp_tpu_torch.solver import cones as tcones
from hdsdp_tpu_torch.solver import psdp as tpsdp
from hdsdp_tpu_torch.solver.params import Params


def _rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def _spd(rng, g, n, shift=0.3):
    Q = rng.standard_normal((g, n, n))
    return Q @ np.swapaxes(Q, 1, 2) / n + shift * np.eye(n)


@pytest.mark.parametrize("name", ["theta", "maxcut", "control", "random"])
def test_build_primal_kkt(name):
    """M_ij = tr(A_i X A_j X) through every bucket, X no inverse of
    anything."""
    data = {
        "theta": lambda: jsyn.theta_sdpa(n=30, n_edges=100, seed=0),
        "maxcut": lambda: jsyn.maxcut_sdpa(n=30, seed=0),
        "control": lambda: jsyn.control_sdpa(k=5, n_sys=2, seed=0),
        "random": lambda: jsyn.random_sdpa(m=30, block_dims=[8], seed=4),
    }[name]()
    prob = JProblem.from_sdpa(data)
    jc = jcones.ConeSystem(prob)
    tg, _ = tcones.groups_from_numpy(jc.groups, None, "cpu", m=prob.m)
    rng = np.random.default_rng(3)
    X = [_spd(rng, g.nblk, g.dim) for g in prob.groups]
    Mj = jpsdp._build_primal_kkt(jc.groups, [jnp.asarray(x) for x in X], prob.m)
    Mt = tpsdp._build_primal_kkt(tg, [torch.as_tensor(x) for x in X], prob.m)
    assert _rel(Mt, Mj) < 1e-12


@pytest.mark.parametrize("n", [12, 200])
def test_primal_ratio_and_post_step(n):
    """Exact eigvalsh below n = 192, f32 Lanczos above (f32 rounding)."""
    rng = np.random.default_rng(n)
    X = _spd(rng, 2, n)
    G = rng.standard_normal((2, n, n))
    dX = (G + np.swapaxes(G, 1, 2)) / np.sqrt(n)
    S = _spd(rng, 2, n)
    okj, sj = jpsdp._primal_ratio((jnp.asarray(X),), (jnp.asarray(dX),))
    okt, st = tpsdp._primal_ratio((torch.as_tensor(X),), (torch.as_tensor(dX),))
    assert bool(okj) and bool(okt)
    assert _rel(st, sj) < (1e-12 if n < 192 else 1e-5)
    okj, cj = jpsdp._post_step((jnp.asarray(X),), (jnp.asarray(S),))
    okt, ct = tpsdp._post_step((torch.as_tensor(X),), (torch.as_tensor(S),))
    assert bool(okj) and bool(okt) and _rel(ct, cj) < 1e-13
    assert _rel(tpsdp._xsx(torch.as_tensor(X), torch.as_tensor(S)),
                jpsdp._xsx(jnp.asarray(X), jnp.asarray(S))) < 1e-13
    bad = X.copy()
    bad[1] -= 5.0 * np.eye(n)
    assert not bool(jpsdp._post_step((jnp.asarray(bad),), (jnp.asarray(S),))[0])
    assert not bool(tpsdp._post_step((torch.as_tensor(bad),), (torch.as_tensor(S),))[0])
    assert not bool(tpsdp._primal_ratio((torch.as_tensor(bad),), (torch.as_tensor(dX),))[0])


def test_psd_checks_see_the_symmetric_part():
    """A matrix whose symmetric part is PD but whose lower triangle,
    mirrored, is not: both packages' refiners check (X + X^T)/2, as
    jnp.linalg.cholesky does by default.  PSDP's X + a dX carries such an
    asymmetry (X S X / mu rounds unsymmetrically) at the size of its
    smallest eigenvalues; reading one triangle made every refinement of
    the port fail with "stepped X not PSD"."""
    rng = np.random.default_rng(0)
    n = 6
    K = rng.standard_normal((n, n))
    K = K - K.T  # antisymmetric: no part of (X + X^T)/2
    X = (np.eye(n) + K)[None]
    assert np.linalg.eigvalsh(np.tril(X[0]) + np.tril(X[0], -1).T).min() < 0
    assert not bool(tchol.psd_check(torch.as_tensor(X))[0])  # one triangle
    assert bool(jchol.psd_check(jnp.asarray(X))[0])
    S = np.eye(n)[None]
    okj, cj = jpsdp._post_step((jnp.asarray(X),), (jnp.asarray(S),))
    okt, ct = tpsdp._post_step((torch.as_tensor(X),), (torch.as_tensor(S),))
    assert bool(okj) and bool(okt) and _rel(ct, cj) < 1e-14
    dX = -0.5 * np.eye(n)[None]
    okj, sj = jpsdp._primal_ratio((jnp.asarray(X),), (jnp.asarray(dX),))
    okt, st = tpsdp._primal_ratio((torch.as_tensor(X),), (torch.as_tensor(dX),))
    assert bool(okj) and bool(okt)
    assert _rel(st, sj) < 1e-12 and float(st) == pytest.approx(2.0, rel=1e-12)


INSTANCES = {
    # name: (family, kwargs, refiner returns a primal)
    "random_s4": ("random_sdpa", dict(m=30, block_dims=[8], seed=4), False),
    "theta60": ("theta_sdpa", dict(n=60, n_edges=400, seed=0), False),
    "random_s0": ("random_sdpa", dict(m=30, block_dims=[8], seed=0), True),
    "theta30": ("theta_sdpa", dict(n=30, n_edges=250, seed=0), True),
}


@pytest.fixture(scope="module", params=sorted(INSTANCES))
def refined(request, tmp_path_factory):
    """Both refiners run from the JAX iterate at the phase-B hook."""
    fam, kw, _ = INSTANCES[request.param]
    path = str(tmp_path_factory.mktemp("psdp") / "state.npz")
    snap = {}
    orig = jpsdp.PSDPRefiner.optimize

    def spy(self):
        ipm = self.ipm
        if "ret" in snap:  # a later call of the same solve
            return orig(self)
        save_checkpoint(path, ipm)
        before = dict(comp=ipm.comp, p_obj_val=ipm.p_obj_val, d_obj_val=ipm.d_obj_val,
                      p_obj_internal=ipm.p_obj_internal, d_obj_internal=ipm.d_obj_internal)
        n0 = ipm.n_iter
        ret = orig(self)
        snap.update(before=before, ret=ret, iters=ipm.n_iter - n0, p_obj=ipm.p_obj_val,
                    d_obj=ipm.d_obj_val, y=np.asarray(ipm.y), status=ipm.status,
                    X=None if self.X is None else [np.asarray(x) for x in self.X])
        return ret

    jpsdp.PSDPRefiner.optimize = spy
    try:
        JSolver(JProblem.from_sdpa(getattr(jsyn, fam)(**kw)), verbose=False,
                fused=False).optimize()
    finally:
        jpsdp.PSDPRefiner.optimize = orig
    assert "ret" in snap, "the JAX solve never reached its refiner"

    ipm = talgo.DualIPM(TProblem.from_sdpa(getattr(tsyn, fam)(**kw)),
                        Params(verbose=False), device="cpu")
    talgo.load_state(ipm, load_checkpoint(path))
    ipm.which_method = "potential"
    for k, v in snap["before"].items():
        setattr(ipm, k, float(v))
    assert ipm.check_is_interior(1.0, ipm.y)
    y0 = ipm.y.clone()
    ref = tpsdp.PSDPRefiner(ipm)
    ret = ref.optimize()
    return dict(name=request.param, snap=snap, ipm=ipm, ref=ref, ret=ret, y0=y0)


def test_refiner_flag_and_iterations(refined):
    snap, ref = refined["snap"], refined["ref"]
    assert refined["ret"] == snap["ret"] == INSTANCES[refined["name"]][2]
    assert abs(ref.n_iter - snap["iters"]) <= 1
    assert ref.n_iter >= 10  # the refinement really iterated


def test_refiner_objectives(refined):
    snap, ipm = refined["snap"], refined["ipm"]
    assert ipm.d_obj_val == pytest.approx(snap["d_obj"], rel=1e-7)
    assert ipm.p_obj_val == pytest.approx(snap["p_obj"], rel=1e-7)


def test_refiner_primal_or_restore(refined):
    snap, ipm, ref = refined["snap"], refined["ipm"], refined["ref"]
    if not refined["ret"]:
        # failure restores the dual iterate (and an interior S for it)
        assert ref.X is None and torch.equal(ipm.y, refined["y0"])
        assert ipm.S is not None and ipm.L is not None
        with pytest.raises(RuntimeError, match="no refined primal"):
            ref.get_primal()
        return
    assert _rel(ipm.y, snap["y"]) < 1e-6
    X_list, x_lp = ref.get_primal()
    assert x_lp is None
    for Xt, Xj in zip(X_list, snap["X"]):
        # the symmetric part; the antisymmetric part is rounding noise of
        # X S X / mu, different in every BLAS
        Xt, Xj = Xt.numpy(), np.asarray(Xj)
        assert _rel(Xt + np.swapaxes(Xt, 1, 2), Xj + np.swapaxes(Xj, 1, 2)) < 1e-5
