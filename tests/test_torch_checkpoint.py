"""Checkpoint and resume in the port (``HDSDPSolver.optimize(resume_from=,
checkpoint_to=)``, utils/checkpoint.py): the JAX package's own cases, and
checkpoints carried between the two packages in both directions, on the
fused default path and on the host loop."""

import numpy as np
import pytest

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver
from hdsdp_tpu_torch.utils import checkpoint as tck

KW = dict(m=20, block_dims=[10], seed=6)


@pytest.fixture(scope="module")
def prob():
    return TProblem.from_sdpa(tsyn.random_sdpa(**KW))


def _t(prob, **over):
    return TSolver(prob, device="cpu", verbose=False, **over)


def test_checkpoint_roundtrip(tmp_path, prob):
    ck = str(tmp_path / "state.npz")
    r1 = _t(prob).optimize(checkpoint_to=ck)
    assert r1.status == "PRIMAL_DUAL_OPTIMAL"
    r2 = _t(prob).optimize(resume_from=ck)
    assert r2.status == "PRIMAL_DUAL_OPTIMAL"
    assert r2.d_obj == pytest.approx(r1.d_obj, rel=1e-8)
    # warm-started solve should not need more iterations
    assert r2.n_iters <= r1.n_iters + 2


def test_dual_start(prob):
    r1 = _t(prob).optimize()
    s2 = _t(prob)
    s2.set_dual_start(np.asarray(r1.y))
    assert s2.optimize().status == "PRIMAL_DUAL_OPTIMAL"


def test_checkpoint_mismatch_rejected(tmp_path, prob):
    ck = str(tmp_path / "state.npz")
    _t(prob).optimize(checkpoint_to=ck)
    other = TProblem.from_sdpa(tsyn.random_sdpa(m=12, block_dims=[6], seed=1))
    with pytest.raises(ValueError, match="m=20"):
        _t(other).optimize(resume_from=ck)


def test_checkpoint_format(tmp_path, prob):
    """The keys and dtypes the JAX package writes, version 1."""
    from hdsdp_tpu.utils.checkpoint import load_checkpoint as jload

    ck_t, ck_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    _t(prob).optimize(checkpoint_to=ck_t)
    JSolver(JProblem.from_sdpa(jsyn.random_sdpa(**KW)), verbose=False).optimize(
        checkpoint_to=ck_j)
    zt, zj = tck.load_checkpoint(ck_t), jload(ck_j)
    assert sorted(zt) == sorted(zj)
    for k in zj:
        assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
    assert int(zt["version"]) == tck.FORMAT_VERSION == 1
    with pytest.raises(ValueError, match="version"):
        np.savez(str(tmp_path / "v2.npz"), **dict(zt, version=2))
        tck.load_checkpoint(str(tmp_path / "v2.npz"))


@pytest.mark.parametrize("fused", ["auto", False])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_resume(tmp_path, prob, fused, writer):
    """A checkpoint written by one package resumes in the other: both
    resumed solves (each package from the same file) are optimal and agree
    to 1e-8 in d_obj."""
    ck = str(tmp_path / "state.npz")
    jprob = JProblem.from_sdpa(jsyn.random_sdpa(**KW))
    if writer == "jax":
        JSolver(jprob, verbose=False, fused=fused).optimize(checkpoint_to=ck)
    else:
        _t(prob, fused=fused).optimize(checkpoint_to=ck)
    rj = JSolver(jprob, verbose=False, fused=fused).optimize(resume_from=ck)
    rt = _t(prob, fused=fused).optimize(resume_from=ck)
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-8)
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.stats["fused"] == ("phase" if fused else False)
