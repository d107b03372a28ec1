"""``kkt_cross_validate`` in the port (utils/kktcheck.py): the bucketed KKT
build against the dense reconstruction M_ij = <A_i, S^-1 A_j S^-1>, and
against the JAX package's diagnostic on the same problem."""

import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.utils.kktcheck import kkt_cross_validate as jcheck
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.utils.kktcheck import kkt_cross_validate

CASES = {
    # the JAX package's own case (tests/test_api.py)
    "mixed": ("random_sdpa", dict(m=14, block_dims=[6, 4], n_lp=3, seed=2)),
    "maxcut_rank1": ("maxcut_sdpa", dict(n=12, seed=0)),
    "theta": ("theta_sdpa", dict(n=10, n_edges=15, seed=1)),
}


def _with_lp(data, io_mod):
    """The instance with a 3-column LP block added: every constraint i
    gets the entry (1 + i % 3) on column i % 3, the objective one entry."""
    m = data.m
    con = np.arange(m + 1, dtype=np.int32)
    var = (con % 3).astype(np.int32)
    val = np.where(con == 0, -1.0, 1.0 + con % 3)
    data.lp = io_mod.LPEntries(ncols=3, con=con, var=var, val=val)
    return data


def _case(pkg, io_mod, name):
    if name == "rank1_with_lp":  # rank-1 coefficients beside an LP block
        return _with_lp(pkg.maxcut_sdpa(n=12, seed=0), io_mod)
    gen, kw = CASES[name]
    return getattr(pkg, gen)(**kw)


@pytest.mark.parametrize("name", sorted(CASES) + ["rank1_with_lp"])
def test_kkt_cross_validate(name):
    from hdsdp_tpu.io import sdpa as jio
    from hdsdp_tpu_torch.io import sdpa as tio

    prob = TProblem.from_sdpa(_case(tsyn, tio, name))
    errs = kkt_cross_validate(prob, device="cpu")
    assert set(errs) == {"M", "asinv", "asinvrdsinv"}
    assert max(errs.values()) < 1e-8
    assert max(jcheck(JProblem.from_sdpa(_case(jsyn, jio, name))).values()) < 1e-8


def test_cases_hold_what_they_name():
    from hdsdp_tpu_torch.io import sdpa as tio

    prob = TProblem.from_sdpa(_case(tsyn, tio, "rank1_with_lp"))
    assert prob.lp is not None and prob.lp.A.shape == (prob.m, 3)
    assert all(info.rank == 1 for info in prob.block_infos[0][1:])


def test_dual_point_and_failure():
    prob = TProblem.from_sdpa(tsyn.random_sdpa(**CASES["mixed"][1]))
    y = np.random.default_rng(0).normal(size=prob.m) * 0.01
    assert max(kkt_cross_validate(prob, y=y, Rd=-2.0, device="cpu").values()) < 1e-8
    with pytest.raises(ValueError, match="interior"):
        kkt_cross_validate(prob, y=1e6 * np.ones(prob.m), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prob = TProblem.from_sdpa(tsyn.random_sdpa(**CASES["mixed"][1]))
    with pytest.raises(RuntimeError, match="cuda"):
        kkt_cross_validate(prob)
