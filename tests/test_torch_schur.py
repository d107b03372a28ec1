"""Cone kernels of the port (ops.schur, ops.chol, ops.ratio, the cone
system's KKT build) against the JAX package on identical arrays.

Both packages get the same group arrays (the JAX presolve's, moved over
by ``groups_from_numpy``) and the same numpy-made S^-1, iterates and
directions.  Tolerance: 1e-12 relative for f64 paths; bitwise where the
Ozaki matmul carries the whole value (the hp Schur matrix of a rank-1
slot group); f32-level for the Lanczos bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.io.sdpa import BlockEntries, SDPAData
from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.ops import chol as jchol
from hdsdp_tpu.ops import ratio as jratio
from hdsdp_tpu.ops import schur as jschur
from hdsdp_tpu.solver import cones as jcones
from hdsdp_tpu_torch.ops import chol as tchol
from hdsdp_tpu_torch.ops import ratio as tratio
from hdsdp_tpu_torch.ops import schur as tschur
from hdsdp_tpu_torch.solver import cones as tcones
from hdsdp_tpu_torch.utils import profile as tprofile

def _diag_perm_sdpa():
    """A diag rank-1 problem no generator makes: m = 8 < n = 12, the
    positions permuted and partly repeated (a non-identity ``dpos``), one
    constraint dense (full rank), so that the dense x diag cross terms run
    through the position map too."""
    n, m = 12, 9
    rng = np.random.default_rng(8)
    pos = np.array([3, 7, 3, 0, 11, 5, 7, 2])
    wts = np.array([1.0, -2.0, 0.5, 1.5, 1.0, 3.0, 1.0, -1.0])
    il, jl = np.tril_indices(n)
    G = rng.standard_normal((n, n))
    C, D = G + G.T, rng.standard_normal((n, n))
    D = D @ D.T + np.eye(n)
    data = SDPAData(m=m, block_dims=[n], b=rng.standard_normal(m))
    data.blocks.append(BlockEntries(
        dim=n,
        con=np.concatenate([np.zeros(len(il)), np.arange(1, 9), np.full(len(il), 9)]).astype(np.int32),
        row=np.concatenate([il, pos, il]).astype(np.int32),
        col=np.concatenate([jl, pos, jl]).astype(np.int32),
        val=np.concatenate([C[il, jl], wts, D[il, jl]]),
    ))
    data.nnz = len(data.blocks[0].val)
    return data


CASES = {
    # slot-major rank-1 slots + a dense bucket (md = 23) + an LP block
    "random": lambda: jsyn.random_sdpa(m=40, block_dims=[30], n_lp=6, seed=1),
    # the slice's structure at n = 40: one rank-1 all-ones slot per row
    "gpp": lambda: jsyn.gpp_sdpa(n=40, seed=0),
    # diag bucket, identity map (m = n)
    "maxcut": lambda: jsyn.maxcut_sdpa(n=40, seed=0),
    # diag bucket, non-identity map, with a dense constraint
    "diagperm": _diag_perm_sdpa,
    # diag bucket + LP cone
    "qpg": lambda: jsyn.qpg_sdpa(n=30, seed=0),
    # support bucket (r = 2, c = 2) + the dense identity row
    "theta": lambda: jsyn.theta_sdpa(n=40, n_edges=120, seed=0),
    # flat layout, g = 3, up to 4 slots per constraint and block
    "control": lambda: jsyn.control_sdpa(k=6, n_sys=2, seed=0),
    # flat layout with a dense bucket spread over three blocks
    "random3": lambda: jsyn.random_sdpa(m=30, block_dims=[30, 30, 30], seed=2),
}
BUCKET = {"random": "slot", "gpp": "slot", "maxcut": "diag", "diagperm": "diag",
          "qpg": "diag", "theta": "support", "control": "flat", "random3": "flat"}
HAS_DENSE = {"random", "diagperm", "theta", "random3"}


def _rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    prob = JProblem.from_sdpa(CASES[request.param]())
    jc = jcones.ConeSystem(prob)
    tg, tlp = tcones.groups_from_numpy(jc.groups, jc.lp, "cpu", m=prob.m)
    rng = np.random.default_rng(11)
    g, n = prob.groups[0].nblk, prob.groups[0].dim
    Q = rng.standard_normal((g, n, n))
    U = Q @ np.swapaxes(Q, 1, 2) / n + 0.5 * np.eye(n)
    S = np.linalg.inv(U)
    s_lp = 0.5 + rng.random(prob.lp.nlp) if prob.lp is not None else None
    return dict(name=request.param, prob=prob, m=prob.m, jc=jc, tg=tg, tlp=tlp,
                U=U, L=np.linalg.cholesky(0.5 * (S + np.swapaxes(S, 1, 2))),
                s_lp=s_lp, y=rng.standard_normal(prob.m))


def test_layout(case):
    """Both presolves choose the bucket the case is named for."""
    name = case["name"]
    assert len(case["tg"]) == 1
    tg = case["tg"][0]
    assert tschur.bucket(tg) == BUCKET[name]
    assert (tg.Ad.shape[0] > 0) == (name in HAS_DENSE)
    if BUCKET[name] == "diag":
        assert (tg.dpos.shape[0] == 0) == (name != "diagperm")  # identity-map marker
    if name == "random3":
        assert len(set(tg.didx.tolist())) < tg.didx.shape[0]  # a row dense in two blocks
    from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
    from hdsdp_tpu_torch.models import synthetic as tsyn

    gen = {"qpg": "qpg_sdpa", "maxcut": "maxcut_sdpa", "theta": "theta_sdpa",
           "control": "control_sdpa"}.get(name)
    if gen:  # the port's own presolve lands in the same bucket, same arrays
        kw = {"qpg": dict(n=30), "maxcut": dict(n=40), "theta": dict(n=40, n_edges=120),
              "control": dict(k=6, n_sys=2)}[name]
        own = tcones.ConeSystem(TProblem.from_sdpa(getattr(tsyn, gen)(seed=0, **kw)), "cpu").groups[0]
        for f in tg._fields:
            a, b = getattr(own, f), getattr(tg, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.shape == b.shape and torch.equal(a, b), f


@pytest.mark.parametrize("hp", [False, True])
def test_group_dual(case, hp):
    jg, tg = case["jc"].groups[0], case["tg"][0]
    y = case["y"]
    Sj = jschur.group_dual(jg, 1.3, -1.0, jnp.asarray(y), 0.7, hp=hp)
    St = tschur.group_dual(tg, 1.3, -1.0, torch.as_tensor(y), 0.7, hp=hp)
    assert _rel(St, Sj) < 1e-12


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("with_m", [True, False])
def test_group_schur(case, hp, with_m):
    jg, tg, m = case["jc"].groups[0], case["tg"][0], case["m"]
    oj = jschur.group_schur(jg, jnp.asarray(case["U"]), m, with_m=with_m, hp=hp)
    ot = tschur.group_schur(tg, torch.as_tensor(case["U"]), m, with_m=with_m, hp=hp)
    for f in ("asinv", "trSAS", "trU"):
        assert _rel(getattr(ot, f), getattr(oj, f)) < 1e-12, f
    if with_m:
        assert _rel(ot.M, oj.M) < 1e-12
        if hp and case["name"] == "gpp":
            # rank-1, no dense bucket: M is the Ozaki pair product squared
            np.testing.assert_array_equal(ot.M.numpy(), np.asarray(oj.M))
    else:
        assert ot.M is None


def test_group_hsd_and_atx(case):
    jg, tg, m = case["jc"].groups[0], case["tg"][0], case["m"]
    U = case["U"]
    hj = jschur.group_hsd(jg, jnp.asarray(U), m)
    ht = tschur.group_hsd(tg, torch.as_tensor(U), m)
    for f in hj._fields:
        assert _rel(getattr(ht, f), getattr(hj, f)) < 1e-12, f
    aj = jschur.group_atx(jg, jnp.asarray(U), m)
    at = tschur.group_atx(tg, torch.as_tensor(U), m)
    assert _rel(at, aj) < 1e-12


def test_lp_functions():
    prob = JProblem.from_sdpa(CASES["random"]())
    jc = jcones.ConeSystem(prob)
    _, tl = tcones.groups_from_numpy(jc.groups, jc.lp, "cpu")
    jl, m = jc.lp, prob.m
    rng = np.random.default_rng(5)
    s = 0.5 + rng.random(prob.lp.nlp)
    y = rng.standard_normal(m)
    assert _rel(tschur.lp_dual(tl, 1.1, -1.0, torch.as_tensor(y), 0.3),
                jschur.lp_dual(jl, 1.1, -1.0, jnp.asarray(y), 0.3)) < 1e-12
    oj = jschur.lp_schur(jl, jnp.asarray(s), m)
    ot = tschur.lp_schur(tl, torch.as_tensor(s), m)
    for f in oj._fields:
        assert _rel(getattr(ot, f), getattr(oj, f)) < 1e-12, f
    hj = jschur.lp_hsd(jl, jnp.asarray(s), m)
    ht = tschur.lp_hsd(tl, torch.as_tensor(s), m)
    for f in hj._fields:
        assert _rel(getattr(ht, f), getattr(hj, f)) < 1e-12, f


@pytest.mark.parametrize("kind", ["inf", "hsd", "corr"])
@pytest.mark.parametrize("hp", [False, True])
def test_build_kkt(case, kind, hp):
    jc, m, L, s = case["jc"], case["m"], case["L"], case["s_lp"]
    kj = jcones._build_kkt(jc.groups, jc.lp, (jnp.asarray(L),),
                           None if s is None else jnp.asarray(s), -0.7, m, kind, hp=hp)
    kt = tcones.build_kkt(case["tg"], case["tlp"], (torch.as_tensor(L),),
                          None if s is None else torch.as_tensor(s), -0.7, m, kind, hp=hp)
    for f in kj._fields:
        vj, vt = getattr(kj, f), getattr(kt, f)
        assert (vj is None) == (vt is None), f
        if vj is not None:
            assert _rel(vt, vj) < 1e-10, f


def _spd(rng, n, batch=1):
    Q = rng.standard_normal((batch, n, n))
    return Q @ np.swapaxes(Q, 1, 2) / n + 0.1 * np.eye(n)


def test_chol_primitives():
    rng = np.random.default_rng(3)
    S = _spd(rng, 25, batch=2)
    W = rng.standard_normal((2, 25, 25))
    W = W + np.swapaxes(W, 1, 2)
    okj, Lj = jchol.psd_check(jnp.asarray(S))
    okt, Lt = tchol.psd_check(torch.as_tensor(S))
    assert bool(okj) and bool(okt)
    assert _rel(Lt, Lj) < 1e-12
    assert _rel(tchol.chol_logdet(Lt), jchol.chol_logdet(Lj)) < 1e-12
    assert _rel(tchol.chol_inverse(Lt), jchol.chol_inverse(Lj)) < 1e-12
    b = rng.standard_normal((2, 25, 3))
    assert _rel(tchol.chol_solve(Lt, torch.as_tensor(b)),
                jchol.chol_solve(Lj, jnp.asarray(b))) < 1e-12
    assert _rel(tchol.congruence(Lt, torch.as_tensor(W)),
                jchol.congruence(Lj, jnp.asarray(W))) < 1e-12
    # an indefinite block: the predicate fails and the factor is NaN
    bad = S.copy()
    bad[1] -= 10.0 * np.eye(25)
    okt, Lt = tchol.psd_check(torch.as_tensor(bad))
    assert not bool(okt) and bool(torch.isnan(Lt[1]).all())
    assert bool(torch.isfinite(Lt[0]).all())
    # use_dd at a single block of n = 512: the double-single inverse from
    # the f64 factor (ops.ddchol).  Its diagonal-block inverses are f64
    # triangular solves, torch's (MKL) and XLA's, which round differently
    # on some CPUs; each is backward stable, so the two inverses lie within
    # n u64 cond(S) of each other (tests/test_torch_ddchol.py holds the rest
    # of the route bit for bit)
    S512 = _spd(rng, 512)
    L512 = np.linalg.cholesky(S512)
    u_dd = tchol.chol_inverse(torch.as_tensor(L512), use_dd=True)
    u_jax = jchol.chol_inverse(jnp.asarray(L512), use_dd=True)
    assert _rel(u_dd, u_jax) <= 512 * 2.0 ** -53 * np.linalg.cond(S512[0])
    assert _rel(u_dd, tchol.chol_inverse(torch.as_tensor(L512))) < 1e-10


@pytest.mark.parametrize("n,mode", [(40, "exact"), (200, "lanczos"), (200, "auto")])
def test_ratio_tests(n, mode):
    rng = np.random.default_rng(n)
    S = _spd(rng, n)
    G = rng.standard_normal((1, n, n))
    dS = (G + np.swapaxes(G, 1, 2)) / np.sqrt(n)
    L = np.linalg.cholesky(S)
    sj, wj = jratio.block_ratio(jnp.asarray(L), jnp.asarray(dS), mode=mode, return_warm=True)
    st, wt = tratio.block_ratio(torch.as_tensor(L), torch.as_tensor(dS), mode=mode,
                                return_warm=True)
    if wj is None:
        assert wt is None and _rel(st, sj) < 1e-12
        return
    # f32 Lanczos: the bound agrees to f32 rounding; the warm start too
    assert _rel(st, sj) < 1e-5
    sj2 = jratio.block_ratio(jnp.asarray(L), jnp.asarray(dS) * 1.1, mode=mode,
                             v0=wj, return_warm=True)[0]
    st2 = tratio.block_ratio(torch.as_tensor(L), torch.as_tensor(dS) * 1.1, mode=mode,
                             v0=torch.tensor(np.asarray(wj)), return_warm=True)[0]
    assert _rel(st2, sj2) < 1e-5
    # the fixed-depth kernel as well
    fj = jratio.block_ratio(jnp.asarray(L), jnp.asarray(dS), mode=mode, adaptive=False)
    ft = tratio.block_ratio(torch.as_tensor(L), torch.as_tensor(dS), mode=mode,
                            adaptive=False)
    assert _rel(ft, fj) < 1e-5
    s = 0.5 + rng.random(7)
    ds = rng.standard_normal(7)
    assert _rel(tratio.vector_ratio_test(torch.as_tensor(s), torch.as_tensor(ds)),
                jratio.vector_ratio_test(jnp.asarray(s), jnp.asarray(ds))) < 1e-15


def test_adaptive_lanczos_never_factors_a_padded_tridiagonal(monkeypatch):
    """The early-exit Lanczos takes its Ritz pairs from the leading block
    of T.  It must not hand the eigensolver the JAX package's fixed-shape
    form (rows not yet built padded with -1e12): cuSOLVER's f32 solver
    returns wrong top pairs for it, or gives up.  The bound is the JAX
    package's all the same (to f32 rounding), early exit included."""
    rng = np.random.default_rng(9)
    n = 200
    S = _spd(rng, n)
    G = rng.standard_normal((1, n, n))
    dS = (G + np.swapaxes(G, 1, 2)) / np.sqrt(n)
    L = np.linalg.cholesky(S)
    real, sizes = torch.linalg.eigh, []

    def watch(A):
        assert float(A.abs().max()) < 1e6, "a padded tridiagonal reached eigh"
        sizes.append(A.shape[-1])
        return real(A)

    monkeypatch.setattr(torch.linalg, "eigh", watch)
    st, wt = tratio.block_ratio(torch.as_tensor(L), torch.as_tensor(dS), mode="lanczos",
                                return_warm=True)
    sj, wj = jratio.block_ratio(jnp.asarray(L), jnp.asarray(dS), mode="lanczos",
                                return_warm=True)
    assert sizes and sizes == sorted(sizes) and all(k % 3 == 0 or k == 30 for k in sizes)
    assert _rel(st, sj) < 1e-5 and _rel(wt, wj) < 1e-4


def _trsv_operator(L, dS, dt):
    """The Lanczos operator by two triangular solves a matvec, the
    reference's form: a yardstick for the port's products with L^{-1}."""
    L, dS = L.to(dt), dS.to(dt)

    def mv(x):
        u = torch.linalg.solve_triangular(L.mT, x[..., None], upper=True)
        return torch.linalg.solve_triangular(L, -(dS @ u), upper=False)[..., 0]

    return mv


def _ratio_case(n, seed, batch=1):
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(_spd(rng, n, batch))
    G = rng.standard_normal((batch, n, n))
    return L, (G + np.swapaxes(G, 1, 2)) / np.sqrt(n)


@pytest.mark.parametrize("leaf", [None, 64, 200])
@pytest.mark.parametrize("lead,n", [((1,), 512), ((1,), 1100), ((3, 1), 777)])
def test_triangular_inverse(monkeypatch, leaf, lead, n):
    """The f32 L^{-1} the Lanczos applies above the gate: its diagonal
    blocks solved against I, the rest joined by products (with and
    without a shorter last block, alone and for a fleet), within f32
    rounding of the f64 inverse, exactly zero above the diagonal, and
    L's copy negated in place only."""
    if leaf is not None:
        monkeypatch.setattr(tratio, "TRI_INV_LEAF", leaf)
    rng = np.random.default_rng(n)
    L = torch.as_tensor(np.linalg.cholesky(_spd(rng, n, int(np.prod(lead))).reshape(lead + (n, n))))
    L0 = L.clone()
    X = tratio._inverse(L, torch.float32)
    want = torch.linalg.solve_triangular(L, torch.eye(n, dtype=L.dtype).expand_as(L), upper=False)
    assert X.dtype == torch.float32 and X.shape == L.shape and torch.equal(L, L0)
    assert bool((torch.triu(X, 1) == 0).all())
    assert _rel(X.double(), want) < 1e-6


@pytest.mark.parametrize("leaf", [None, 200])
@pytest.mark.parametrize("adaptive", [False, True])
def test_ratio_inverse_path_matches_jax(monkeypatch, adaptive, leaf):
    """Through the explicit f32 L^{-1} the Lanczos applies (one diagonal
    block, or with a smaller TRI_INV_LEAF blocks joined by products), the
    fixed-depth and the adaptive bound agree with the JAX package's
    triangular solves to f32 rounding, cold and warm-started; a fleet
    [N, 1, n, n] gives each member its solo bound to f32 rounding (batched
    and single products round apart, as triangular solves do)."""
    if leaf is not None:
        monkeypatch.setattr(tratio, "TRI_INV_LEAF", leaf)
    n = 512
    L, dS = _ratio_case(n, 21)
    kw = dict(mode="lanczos", return_warm=True, adaptive=adaptive)
    if not adaptive:
        kw["krylov"] = 16
    sj, wj = jratio.block_ratio(jnp.asarray(L), jnp.asarray(dS), **kw)
    with tprofile.recording() as rec:
        st, wt = tratio.block_ratio(torch.as_tensor(L), torch.as_tensor(dS), **kw)
    assert rec.counters.get("ratio_inverse") == 1
    assert _rel(st, sj) < 1e-5 and _rel(wt, wj) < 1e-4
    sj2 = jratio.block_ratio(jnp.asarray(L), jnp.asarray(dS) * 1.1, v0=wj, **kw)[0]
    st2 = tratio.block_ratio(torch.as_tensor(L), torch.as_tensor(dS) * 1.1,
                             v0=torch.tensor(np.asarray(wj)), **kw)[0]
    assert _rel(st2, sj2) < 1e-5
    # a fleet of three: member 1 is the block above, 0 and 2 others
    Lf, dSf = _ratio_case(n, 22, batch=3)
    Lf[1], dSf[1] = L[0], dS[0]
    sf, wf = tratio.block_ratio(torch.as_tensor(Lf[:, None]), torch.as_tensor(dSf[:, None]), **kw)
    assert sf.shape == (3, 1) and wf.shape == (3, 1, n)
    for i in range(3):
        si, wi = tratio.block_ratio(torch.as_tensor(Lf[i:i + 1]), torch.as_tensor(dSf[i:i + 1]),
                                    **kw)
        assert _rel(sf[i], si) < 1e-5 and _rel(wf[i], wi) < 1e-4
    assert _rel(sf[1], st) < 1e-5


@pytest.mark.parametrize("leaf", [None, 200])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_ratio_inverse_path_ill_conditioned(monkeypatch, adaptive, seed, leaf):
    """On an S with condition 1e8, as late iterations have, with the top
    of the operator's spectrum in S's small eigenvalues: the bound through
    the explicit f32 inverse (one block, or blocks joined by products;
    before the 0.995 factor) is no further from the f64 exact step than
    twice the bound through two triangular solves a matvec, or than 1e-6
    (a few f32 roundings) where that one is closer; with the factor it is
    never above the exact step."""
    if leaf is not None:
        monkeypatch.setattr(tratio, "TRI_INV_LEAF", leaf)
    n = 512
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    S = (Q * np.logspace(0, -8, n)) @ Q.T
    L = torch.as_tensor(np.linalg.cholesky(0.5 * (S + S.T))[None])
    G = rng.standard_normal((1, n, n))
    dS = torch.as_tensor((G + np.swapaxes(G, 1, 2)) * 1e-6 / np.sqrt(n) - 1e-7 * S)
    exact = float(tratio.exact_ratio_test(L, dS)[0])
    kw = dict(mode="lanczos", adaptive=adaptive, krylov=30 if adaptive else 16)
    gemv = float(tratio.block_ratio(L, dS, **kw)[0])
    monkeypatch.setattr(tratio, "_operator", _trsv_operator)
    trsv = float(tratio.block_ratio(L, dS, **kw)[0])
    assert np.isfinite(exact) and 0 < gemv <= exact
    err_t = abs(trsv / 0.995 - exact) / exact
    assert abs(gemv / 0.995 - exact) / exact <= max(2.0 * err_t, 1e-6)


@pytest.mark.parametrize("split", [True, False])
def test_ratio_nan_factor(monkeypatch, split):
    """A NaN factor under nan_safe, with L^{-1} formed from one diagonal
    block or from blocks joined by products: the member gets the JAX
    package's answer, a NaN warm vector and the no-bound sentinel step
    (NaN Ritz values fail the bound's positivity test), and the other
    members of the fleet keep their own steps."""
    n = 512
    if split:
        monkeypatch.setattr(tratio, "TRI_INV_LEAF", 200)
    L, dS = _ratio_case(n, 23, batch=2)
    L[0, 3:, 2] = np.nan
    kw = dict(krylov=16, return_warm=True, adaptive=False)
    sj, _ = jratio.block_ratio(jnp.asarray(L[:, None]), jnp.asarray(dS[:, None]), **kw)
    with tprofile.recording() as rec:
        steps, warm = tratio.block_ratio(torch.as_tensor(L[:, None]),
                                         torch.as_tensor(dS[:, None]), nan_safe=True, **kw)
    assert rec.counters.get("ratio_inverse") == 1
    assert float(steps[0, 0]) == float(np.asarray(sj)[0, 0]) > 1e29
    assert bool(torch.isnan(warm[0]).all()) and bool(torch.isfinite(warm[1]).all())
    alone = tratio.block_ratio(torch.as_tensor(L[1:]), torch.as_tensor(dS[1:]), krylov=16,
                               adaptive=False, nan_safe=True)
    assert _rel(steps[1], alone) < 1e-5 and _rel(steps[1], np.asarray(sj)[1]) < 1e-5


@pytest.mark.parametrize("side", ["below", "at"])
def test_ratio_inverse_gate(side):
    """The counter ``ratio_inverse`` counts one per group and Lanczos test,
    with a span around the inverse; below AUTO_LANCZOS_DIM, where the test
    is the exact eigenvalues', it counts none and block_ratio returns
    exact_ratio_test's bits."""
    n = tratio.AUTO_LANCZOS_DIM - (side == "below")
    L, dS = _ratio_case(n, 24, batch=2)
    L, dS = torch.as_tensor(L), torch.as_tensor(dS)
    with tprofile.recording() as rec:
        for _ in range(2):
            got = tratio.block_ratio(L, dS, krylov=16, adaptive=False)
    assert rec.counters.get("ratio_inverse", 0) == 2 * (side == "at")
    assert [sp.name for sp in rec.spans] == ["ratio_inverse"] * (2 * (side == "at"))
    if side == "below":
        assert torch.equal(got, tratio.exact_ratio_test(L, dS))


def _own_groups(name, layout):
    """The port's presolve of a case under a forced layout."""
    from hdsdp_tpu_torch.io.sdpa import BlockEntries as TBlock, LPEntries as TLP, SDPAData as TData
    from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem

    d = CASES[name]()
    t = TData(m=d.m, block_dims=list(d.block_dims), b=np.array(d.b))
    for blk in d.blocks:
        t.blocks.append(TBlock(dim=blk.dim, con=blk.con, row=blk.row, col=blk.col, val=blk.val))
    if d.lp is not None:
        t.lp = TLP(ncols=d.lp.ncols, con=d.lp.con, var=d.lp.var, val=d.lp.val)
    t.nnz = d.nnz
    prob = TProblem.from_sdpa(t)
    return prob, tcones.ConeSystem(prob, "cpu", layout=layout).groups[0]


@pytest.mark.parametrize("name,other", [
    ("maxcut", "slot"), ("diagperm", "slot"), ("qpg", "slot"), ("theta", "slot"),
    ("theta", "flat"), ("random", "flat"), ("maxcut", "flat"),
])
def test_bucket_matches_other_layout(name, other):
    """Each specialised bucket against the port's own generic slot-major
    path, and slot-major against the flat layout, on one problem: M, the
    RHS rows, the dual assembly, the HSD row and A(X)."""
    prob, ga = _own_groups(name, "auto")
    _, gb = _own_groups(name, other)
    assert tschur.bucket(ga) == BUCKET[name] and tschur.bucket(gb) == other
    rng = np.random.default_rng(2)
    n, m = prob.groups[0].dim, prob.m
    Q = rng.standard_normal((n, n))
    U = torch.as_tensor(Q @ Q.T + n * np.eye(n))[None]
    y = torch.as_tensor(rng.standard_normal(m))
    a = tschur.group_schur(ga, U, m)
    b = tschur.group_schur(gb, U, m)
    for f in ("M", "asinv", "trSAS", "trU"):
        assert _rel(getattr(a, f), getattr(b, f)) < 1e-12, f
    assert _rel(tschur.group_dual(ga, -1.0, -1.0, y, 2.0),
                tschur.group_dual(gb, -1.0, -1.0, y, 2.0)) < 1e-12
    assert _rel(tschur.group_hsd(ga, U, m).asinvcsinv,
                tschur.group_hsd(gb, U, m).asinvcsinv) < 1e-12
    assert _rel(tschur.group_atx(ga, U, m), tschur.group_atx(gb, U, m)) < 1e-12


def test_table_sum_is_a_segment_sum():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, size=50)
    keep = rng.random(50) < 0.8
    vals = rng.standard_normal((3, 50))
    tab = tschur.gather_table(idx, 9, keep)
    assert tab.shape[0] == 9 and (np.diff(np.where(tab == 50, 10**6, tab), axis=1) >= 0).all()
    out = tschur._table_sum(torch.as_tensor(vals), torch.as_tensor(tab)).numpy()
    want = np.zeros((3, 9))
    for t in np.nonzero(keep)[0]:
        want[:, idx[t]] += vals[:, t]
    np.testing.assert_allclose(out, want, rtol=1e-14, atol=1e-14)
    assert tschur.gather_table(np.zeros(0, np.int64), 4).shape == (4, 1)


# ----------------------------------------------------------------------
# column views: a block of constraint rows against the whole group (the
# row-sharded mesh assembly, hdsdp_tpu_torch.parallel.schur)
# ----------------------------------------------------------------------

ROW_BLOCKS = (0.0, 0.3, 0.5, 1.0)  # fractions of m: three blocks of rows


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("with_m", [True, False])
def test_row_view_rows(case, hp, with_m):
    """Each block's rows of M and its entries of ASinv, trSAS and the HSD
    vector, from ``group_schur(row_view, col=group)``, against the whole
    group's: bit for bit for the gather buckets (diag, support: the (k, j)
    partner is built as the transpose of the (j, k) pair) and for a
    rank-1 slot group without dense part (gpp); ~2^-45 relative for the
    slot bucket with dense coefficients, under hp too.  Flat groups take
    no column view."""
    from hdsdp_tpu_torch.parallel.schur import row_view

    tg, m = case["tg"][0], case["m"]
    U = torch.as_tensor(case["U"])
    if tschur.bucket(tg) == "flat":
        with pytest.raises(ValueError):
            tschur.group_schur(tg, U, m, with_m=with_m, col=tg)
        return
    full = tschur.group_schur(tg, U, m, with_m=with_m, hp=hp)
    hfull = tschur.group_hsd(tg, U, m)
    bitwise = case["name"] != "random"
    cuts = [int(round(f * m)) for f in ROW_BLOCKS]
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        v = row_view(tg, r0, r1)
        out = tschur.group_schur(v, U, m, with_m=with_m, hp=hp, col=tg)
        pairs = [(out.asinv, full.asinv[r0:r1]), (out.trSAS, full.trSAS[r0:r1]),
                 (tschur.group_hsd(v, U, m).asinvcsinv, hfull.asinvcsinv[r0:r1])]
        if with_m:
            assert out.M.shape == (r1 - r0, m)
            pairs.append((out.M, full.M[r0:r1]))
        else:
            assert out.M is None
        assert torch.equal(out.trU, full.trU)
        for got, want in pairs:
            if bitwise:
                assert torch.equal(got, want), (r0, r1)
            else:
                assert _rel(got, want.numpy()) <= 2.0 ** -45, (r0, r1)
