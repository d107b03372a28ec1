"""Host side of the port (SDPA I/O, presolve, features, bucket choice)
against the JAX package on the same synthetic instances."""

import dataclasses
import io

import numpy as np
import pytest

from hdsdp_tpu.io import sdpa as jsdpa
from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver.cones import ConeSystem as JCones
from hdsdp_tpu_torch.io import sdpa as tsdpa
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.ops.schur import bucket
from hdsdp_tpu_torch.solver.cones import ConeSystem as TCones

FAMILIES = {
    "gpp": ("gpp_sdpa", dict(n=20, seed=0)),
    "theta": ("theta_sdpa", dict(n=15, n_edges=30, seed=1)),
    "maxcut": ("maxcut_sdpa", dict(n=20, seed=2)),
    "control": ("control_sdpa", dict(k=4, n_sys=2, seed=3)),
    "random": ("random_sdpa", dict(m=12, block_dims=[8, 6], n_lp=3, seed=4)),
}

# the layout both presolves choose per family (one entry per group)
EXPECTED_BUCKETS = {
    "gpp": ["slot"],
    "theta": ["support"],
    "maxcut": ["diag"],
    "control": ["flat"],
    "random": ["support", "support"],
}


def _data(pkg, family):
    name, kw = FAMILIES[family]
    return getattr(pkg, name)(**kw)


def _assert_data_equal(a, b):
    assert a.m == b.m and list(a.block_dims) == list(b.block_dims)
    np.testing.assert_array_equal(a.b, b.b)
    assert len(a.blocks) == len(b.blocks)
    for x, y in zip(a.blocks, b.blocks):
        assert x.dim == y.dim
        for f in ("con", "row", "col", "val"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert (a.lp is None) == (b.lp is None)
    if a.lp is not None:
        assert a.lp.ncols == b.lp.ncols
        for f in ("con", "var", "val"):
            np.testing.assert_array_equal(getattr(a.lp, f), getattr(b.lp, f))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_synthetic_copy_matches_jax(family):
    _assert_data_equal(_data(tsyn, family), _data(jsyn, family))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sdpa_round_trip(family, tmp_path):
    data = _data(tsyn, family)
    path = tmp_path / f"{family}.dat-s"
    tsdpa.write_sdpa(data, str(path))
    back = tsdpa.read_sdpa(str(path))
    _assert_data_equal(back, jsdpa.read_sdpa(str(path)))
    # reading drops |val| < 1e-12 entries; after that the pair is a
    # fixed point (repr() round-trips every f64)
    buf = io.StringIO()
    tsdpa.write_sdpa(back, buf)
    buf.seek(0)
    _assert_data_equal(tsdpa.read_sdpa(buf), back)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_problem_and_features_match_jax(family):
    tp = TProblem.from_sdpa(_data(tsyn, family))
    jp = JProblem.from_sdpa(_data(jsyn, family))
    assert dataclasses.asdict(tp.features) == dataclasses.asdict(jp.features)
    np.testing.assert_array_equal(tp.b, jp.b)
    assert len(tp.groups) == len(jp.groups)
    for tg, jg in zip(tp.groups, jp.groups):
        assert (tg.dim, tg.nblk, tg.block_ids) == (jg.dim, jg.nblk, jg.block_ids)
        for f in ("C", "F", "lam", "seg", "Ad", "didx", "dblk"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    assert (tp.lp is None) == (jp.lp is None)
    if tp.lp is not None:
        np.testing.assert_array_equal(tp.lp.A, jp.lp.A)
        np.testing.assert_array_equal(tp.lp.c, jp.lp.c)


def _jax_bucket(ga):
    if ga.dpos is not None:
        return "diag"
    if ga.spos is not None:
        return "support"
    if ga.Fs is not None:
        return "slot"
    return "flat"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bucket_choice_matches_jax(family):
    tp = TProblem.from_sdpa(_data(tsyn, family))
    jp = JProblem.from_sdpa(_data(jsyn, family))
    tc = TCones(tp, device="cpu")
    jc = JCones(jp)
    assert [bucket(g) for g in tc.groups] == [_jax_bucket(g) for g in jc.groups]
    assert [bucket(g) for g in tc.groups] == EXPECTED_BUCKETS[family]
    for tg, jg in zip(tc.groups, jc.groups):
        for f in jg._fields:  # the port adds its summation tables to these
            tv, jv = getattr(tg, f), getattr(jg, f)
            assert (tv is None) == (jv is None), f
            if tv is not None:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
