"""The port's double-single blocked Cholesky (ops/ddchol.py), its routes in
ops/chol.py, and the kkt_fp="dd" solve, against the
JAX package on identical seeded numpy inputs.

Bit for bit where both sides run the same IEEE operations: the panel
factor against the JAX ``_panel_factor`` run op by op (``jax.disable_jit``),
a fleet against its single factors, and ``spd_inverse`` of the factor that
``factor_from_f64_tri`` wraps, given the same diagonal-block inverses W.
Those W are f64 triangular solves, torch's (MKL) and XLA's, whose bits
differ by host CPU: so ``spd_inverse_from_f64_tri`` from the f64 factor
alone is held to the bound of its W (``_w_bound``).  Jitted JAX
results are held to 1e-12 relative in f64: inside a jitted program XLA's
CPU backend contracts a * b - c into fused multiply-adds, which moves the
low words of Dekker's two_prod (the port, like the kernel K8 on the card,
keeps every product and sum its own IEEE operation).  The plain panel
factor is ~40 k small operations per 256-panel here, so the sizes are few."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.ops import chol as jchol
from hdsdp_tpu.ops import dd as jdd
from hdsdp_tpu.ops import ddchol as jdc
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.ops import chol as tchol
from hdsdp_tpu_torch.ops import dd as tdd
from hdsdp_tpu_torch.ops import ddchol as tdc
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain panel factor is thousands of tiny torch calls, which stall
    when every worker of the tier-1 run spins eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def _bits(t, j) -> bool:
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    nt, nj = np.isnan(t), np.isnan(j)
    iv = np.int32 if t.dtype == np.float32 else np.int64
    return bool(t.shape == j.shape and np.array_equal(nt, nj)
                and np.array_equal(np.where(nt, 0, t).view(iv), np.where(nj, 0, j).view(iv)))


def _w_bound(n, cond):
    """How far two DD inverses from one f64 factor may lie apart when their
    diagonal-block inverses W are two backward-stable f64 triangular solves
    (torch's MKL and XLA's, which round differently on some CPUs): each W
    within ~n u64 of the exact one, amplified by at most cond(A) through
    the strips and G^T G."""
    return n * 2.0 ** -53 * cond


def _spd(rng, n, cond=1e3):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.logspace(0, -np.log10(cond), n)) @ q.T
    return 0.5 * (a + a.T)


def _dd(a):
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("b", [32, 64])
def test_panel_factor_bitwise_against_eager_jax(b):
    """The plain panel factor (K8's reference) against the JAX sweep run
    op by op: L and W bit for bit, signed zeros included."""
    rng = np.random.default_rng(b)
    ph, pl = _dd(_spd(rng, b, 1e4))
    with jax.disable_jit():
        jout = jdc._panel_factor(jnp.asarray(ph), jnp.asarray(pl))
    tout = tdc.panel_factor_ref(torch.as_tensor(ph), torch.as_tensor(pl))
    assert all(_bits(t, j) for t, j in zip(tout, jout))


def test_panel_factor_against_jitted_jax_and_fleet():
    """At B = 256 against the jitted JAX sweep (1e-12 in f64), and a fleet
    of three panels (one indefinite) against its single factors, bitwise;
    panel_factor takes the plain version for CPU tensors."""
    rng = np.random.default_rng(5)
    mats = [_spd(rng, 256, 1e2), _spd(rng, 256, 1e10), _spd(rng, 256, 1e2) - 0.5 * np.eye(256)]
    ph, pl = _dd(mats[0])
    jl = jdc._panel_factor(jnp.asarray(ph), jnp.asarray(pl))
    tl = tdc.panel_factor(torch.as_tensor(ph), torch.as_tensor(pl))
    assert _rel(tdd.to_f64(tl[0], tl[1]), jdd.to_f64(jl[0], jl[1])) < 1e-12
    assert _rel(tdd.to_f64(tl[2], tl[3]), jdd.to_f64(jl[2], jl[3])) < 1e-12
    fh, fl = _dd(np.stack(mats))
    fleet = tdc.panel_factor(torch.as_tensor(fh), torch.as_tensor(fl))
    assert all(_bits(f[0], t) for f, t in zip(fleet, tl))
    for i in (1, 2):
        single = tdc.panel_factor_ref(torch.as_tensor(fh[i]), torch.as_tensor(fl[i]))
        assert all(_bits(f[i], s) for f, s in zip(fleet, single))
    assert bool(torch.isnan(fleet[0][2]).any()) and not bool(torch.isnan(fleet[0][0]).any())
    assert tdc.PANEL_LAUNCHES == 0  # the plain version never counts


@pytest.mark.parametrize("n,block", [(100, 32), (300, 128), (512, 256)])
def test_factor_solve_inverses_against_jax(n, block):
    """Every output against the JAX package's at 1e-12 relative, on a
    matrix of condition number 10: the two factors differ in their last
    bits (the JAX side's fused multiply-adds), which a solve or an inverse
    amplifies by the condition number; accuracy at high condition numbers
    is held against the f64 truth below."""
    rng = np.random.default_rng(n)
    a = _spd(rng, n, 10.0)
    fj = jdc.factor(jnp.asarray(a), block=block)
    ft = tdc.factor(torch.as_tensor(a), block=block)
    assert bool(jdc.ok(fj)) and bool(tdc.ok(ft))
    assert _rel(tdd.to_f64(ft.lh, ft.ll), jdd.to_f64(fj.lh, fj.ll)) < 1e-12
    assert _rel(tdd.to_f64(ft.wh, ft.wl), jdd.to_f64(fj.wh, fj.wl)) < 1e-12
    assert _rel(tdc.logdet(ft, n), jdc.logdet(fj, n)) < 1e-12
    b = rng.standard_normal((n, 3))
    xt = tdc.solve(ft, torch.as_tensor(b))
    assert _rel(xt, jdc.solve(fj, jnp.asarray(b))) < 1e-12
    assert _rel(tdc.solve(ft, torch.as_tensor(b[:, 0])), jdc.solve(fj, jnp.asarray(b[:, 0]))) < 1e-12
    assert _rel(tdd.to_f64(*tdc.tri_inverse(ft)), jdd.to_f64(*jdc.tri_inverse(fj))) < 1e-12
    assert _rel(tdc.spd_inverse(ft, n), jdc.spd_inverse(fj, n)) < 1e-12
    L = np.linalg.cholesky(a)
    ut = tdc.spd_inverse_from_f64_tri(torch.as_tensor(L), block=block)
    assert _rel(ut, jdc.spd_inverse_from_f64_tri(jnp.asarray(L), block=block)) <= _w_bound(n, 10.0)
    # given JAX's W, the port's strips and product are JAX's bit for bit
    wj = jdc.factor_from_f64_tri(jnp.asarray(L), block=block)
    wt = tdc.factor_from_f64_tri(torch.as_tensor(L), block=block)
    assert _bits(wt.lh, wj.lh) and _bits(wt.ll, wj.ll)
    same_w = wt._replace(wh=torch.as_tensor(np.asarray(wj.wh)), wl=torch.as_tensor(np.asarray(wj.wl)))
    assert _bits(tdc.spd_inverse(same_w, n), jdc.spd_inverse(wj, n))
    assert _rel(tdc.chol_f64(torch.as_tensor(a), block=block), L) < 1e-12


@pytest.mark.parametrize("cond", [1e2, 1e8, 1e12])
def test_solve_and_inverse_accuracy(cond):
    """The JAX package's own accuracy holds (tests/test_ddchol.py): the
    forward error of a solve ~ cond 2^-45, the inverse's residual likewise,
    the factor's residual 1e-12."""
    rng = np.random.default_rng(3)
    n = 200
    a = _spd(rng, n, cond)
    x_true = rng.normal(size=(n, 3))
    f = tdc.factor(torch.as_tensor(a), block=64)
    x = tdc.solve(f, torch.as_tensor(a @ x_true)).numpy()
    assert np.abs(x - x_true).max() / np.abs(x_true).max() < 3e-13 * cond + 1e-11
    L = tdc.chol_f64(torch.as_tensor(a), block=64).numpy()
    assert np.abs(L @ L.T - a).max() / np.abs(a).max() < 1e-12
    if cond <= 1e8:
        inv = tdc.spd_inverse(f, n).numpy()
        assert np.abs(inv @ a - np.eye(n)).max() < 3e-13 * cond + 1e-11


def test_indefinite_fails_ok_in_both():
    rng = np.random.default_rng(9)
    a = _spd(rng, 300, 1e2) - 0.5 * np.eye(300)
    assert not bool(jdc.ok(jdc.factor(jnp.asarray(a), block=128)))
    assert not bool(tdc.ok(tdc.factor(torch.as_tensor(a), block=128)))


def test_fleet_factor_bitwise_against_single_factors():
    """A fleet's DD factor (the cone factor of solve_batch with
    cone_fp="dd") against its N single factors, bit for bit, and ok per
    instance."""
    rng = np.random.default_rng(12)
    mats = np.stack([_spd(rng, 200, 1e4), _spd(rng, 200, 1e2) - 0.6 * np.eye(200),
                     _spd(rng, 200, 1e8)])
    ff = tdc.factor(torch.as_tensor(mats), block=64)
    assert tdc.ok(ff).tolist() == [True, False, True]
    for i in range(3):
        fs = tdc.factor(torch.as_tensor(mats[i]), block=64)
        assert all(_bits(x[i], y) for x, y in zip(ff, fs))
    g = tdc.tri_inverse(ff)
    assert all(_bits(x[0], y) for x, y in zip(g, tdc.tri_inverse(tdc.DDFactor(
        *(t[0] for t in ff)))))


def test_psd_factor_and_chol_inverse_use_dd_at_512():
    """ops.chol's DD routes at their threshold, n = 512: psd_factor through
    ddchol.factor (and a fleet's [N, 1, n, n]), chol_inverse through
    ddchol.spd_inverse_from_f64_tri (against JAX within ``_w_bound`` of S's
    condition); below it both keep the f64 path."""
    rng = np.random.default_rng(14)
    S = (_spd(rng, 512, 1e5) + 1e-2 * np.eye(512))[None]
    okj, Lj = jchol.psd_factor(jnp.asarray(S), use_dd=True)
    okt, Lt = tchol.psd_factor(torch.as_tensor(S), use_dd=True)
    assert bool(okj) and bool(okt) and Lt.shape == (1, 512, 512)
    assert _rel(Lt, Lj) < 1e-12
    bad = S - 0.5 * np.eye(512)
    assert not bool(jchol.psd_factor(jnp.asarray(bad), use_dd=True)[0])
    assert not bool(tchol.psd_factor(torch.as_tensor(bad), use_dd=True)[0])
    okf, Lf = tchol.psd_factor(torch.as_tensor(np.stack([S, bad])), use_dd=True, lead=(2,))
    assert okf.tolist() == [True, False] and _bits(Lf[0], Lt)
    L = np.linalg.cholesky(S)
    uj = jchol.chol_inverse(jnp.asarray(L), use_dd=True)
    ut = tchol.chol_inverse(torch.as_tensor(L), use_dd=True)
    assert _rel(ut, uj) <= _w_bound(512, np.linalg.cond(S[0]))
    assert _rel(ut, np.linalg.inv(S)) < 1e-10
    small = torch.as_tensor(L[:, :511, :511])
    assert _rel(tchol.chol_inverse(small, use_dd=True), tchol.chol_inverse(small)) == 0.0


def test_kkt_fp_dd_host_loop_matches_jax(monkeypatch):
    """gpp n = 40 on the host loop with the Schur factor by ddchol (m = 41,
    one 256-panel a factor) and f64 refinement, against the JAX package's
    same run: status, d_obj 1e-7 and the DIMACS grade.  The iteration count
    is not held: the last bits of the host BLAS's f64 products (its thread
    count and code path) steer the endgame, where M's condition reaches
    ~1e14, into more or fewer short steps (on one CPU the port took 22 at
    eight threads and 28 at one, 26 on MKL's AVX2 path; JAX 22)."""
    from hdsdp_tpu_torch.solver import algo as talgo

    over = dict(fused=False, kkt_fp="dd")
    rj = JSolver(JProblem.from_sdpa(jsyn.gpp_sdpa(n=40, seed=0)), verbose=False, **over).optimize()
    kinds = []
    plain = talgo.DualIPM._direct_factor

    def direct(self, M):
        plain(self, M)
        kinds.append(self.Mfac[0])

    monkeypatch.setattr(talgo.DualIPM, "_direct_factor", direct)
    rt = TSolver(TProblem.from_sdpa(tsyn.gpp_sdpa(n=40, seed=0)), device="cpu",
                 verbose=False, **over).optimize()
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL", (rt.n_iters, rj.n_iters)
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    # gpp40's last maker is nearly singular (cond ~1e14, tests/test_torch_solver.py):
    # both checks land at a few 1e-6
    assert np.max(np.abs(rt.dimacs)) <= 10.0 * np.max(np.abs(rj.dimacs)) + 1e-8
    assert kinds and set(kinds) == {"ddchol"}


def _panel_kinds(rng, b):
    """The four panel kinds of chip_smoke.py's kernel phase."""
    d = np.logspace(-14, 14, b)
    return {
        "well-conditioned": _spd(rng, b, 1e2) + np.eye(b),
        "cond 1e12": _spd(rng, b, 1e12),
        "indefinite": _spd(rng, b, 1e2) - 0.5 * np.eye(b),
        "wild scales": d[:, None] * (_spd(rng, b, 1e2) + np.eye(b)) * d[None, :],
    }


def _tree_node(a, b):
    """One node of dd_sum's tree, a the lower-index operand."""
    s, e = tdd.two_sum(a[0], b[0])
    return tdd.quick_two_sum(s, e + a[1] + b[1])


def _k8_mirror(ph, pl):
    """K8's order of operations (csrc/dd_panel.cu), in plain torch, for one
    [B, B] panel: phase L updates only the trailing block's strictly lower
    triangle and the diagonal, one step at a time (the kernel's strip is
    one column; its copies of the diagonal and subdiagonal take the same
    operations); phase W builds W column by column, W[j, k] from the final
    row j of L and the leaves i in [k, j), every other leaf the constant
    (+0, +0), with the kernel's tree: leaf i in lane i % 32, slot i // 32,
    the slots summed in-lane first (a node whose two subtrees hold no leaf
    in [k, j) skipped, as the kernel skips it), then the lanes with strides
    16 .. 1.  Vectorised over the columns k."""
    b = ph.shape[-1]
    ns = b // 32
    z = torch.zeros((), dtype=torch.float32)
    rid = torch.arange(b)
    strict = rid[:, None] > rid[None, :]
    sh, sl = torch.where(strict, ph, z), torch.where(strict, pl, z)  # P, then L in place
    dh, dl = ph.diagonal().clone(), pl.diagonal().clone()  # P[i, i], then L[i, i]
    ish, isl = torch.zeros(b), torch.zeros(b)
    for j in range(b):
        ih, il = tdd.inv(*tdd.sqrt(dh[j:j + 1], dl[j:j + 1]))
        ish[j], isl[j] = ih[0], il[0]
        xh = torch.cat([dh[j:j + 1], sh[j + 1:, j]])
        xl = torch.cat([dl[j:j + 1], sl[j + 1:, j]])
        ch, cl = tdd.mul(xh, xl, ih, il)  # rows j ..
        sh[j + 1:, j], sl[j + 1:, j] = ch[1:], cl[1:]
        dh[j], dl[j] = ch[0], cl[0]
        th, tl = ch[1:], cl[1:]  # rows j + 1 ..
        oh, ol = tdd.mul(th[:, None], tl[:, None], th[None, :], tl[None, :])
        uh, ul = tdd.sub(sh[j + 1:, j + 1:], sl[j + 1:, j + 1:], oh, ol)
        low = strict[j + 1:, j + 1:]
        sh[j + 1:, j + 1:] = torch.where(low, uh, sh[j + 1:, j + 1:])
        sl[j + 1:, j + 1:] = torch.where(low, ul, sl[j + 1:, j + 1:])
        gh, gl = tdd.sub(dh[j + 1:], dl[j + 1:], *tdd.mul(th, tl, th, tl))
        dh[j + 1:], dl[j + 1:] = gh, gl
    lh = sh + torch.diag(dh)
    ll = sl + torch.diag(dl)

    wh, wl = torch.zeros(b, b), torch.zeros(b, b)
    k = rid[None, :]
    for j in range(b):
        # leaves [i, k] = L[j, i] W[i, k] for k <= i < j, else (+0, +0)
        here = (rid[:, None] >= k) & (rid[:, None] < j)
        qh, ql = tdd.mul(lh[j][:, None], ll[j][:, None], wh, wl)
        vh = torch.where(here, qh, z).reshape(ns, 32, b)
        vl = torch.where(here, ql, z).reshape(ns, 32, b)
        # slot m holds a leaf of column k (the same for every lane)
        m0 = 32 * torch.arange(ns)[:, None]
        pres = torch.maximum(k, m0) < torch.minimum(torch.tensor(j), m0 + 32)  # [ns, b]
        h = ns // 2
        while h >= 1:
            take = pres[:h] | pres[h:2 * h]
            nh, nl = _tree_node((vh[:h], vl[:h]), (vh[h:2 * h], vl[h:2 * h]))
            vh = torch.where(take[:, None, :], nh, vh[:h])
            vl = torch.where(take[:, None, :], nl, vl[:h])
            pres = take
            h //= 2
        ah, al = vh[0], vl[0]  # [32 lanes, b]
        s = 16
        while s >= 1:
            ah, al = _tree_node((ah[:s], al[:s]), (ah[s:2 * s], al[s:2 * s]))
            s //= 2
        eh = torch.where(rid == j, 1.0, 0.0)
        xh, xl = tdd.mul(*tdd.sub(eh, torch.zeros(b), ah[0], al[0]), ish[j], isl[j])
        uh, ul = tdd.mul(*tdd.sub(z, z, z, z), ish[j], isl[j])  # W[j, k], k > j
        wh[j] = torch.where(rid <= j, xh, uh)
        wl[j] = torch.where(rid <= j, xl, ul)
    return lh, ll, wh, wl


@pytest.mark.parametrize("kind", ["well-conditioned", "cond 1e12", "indefinite", "wild scales"])
@pytest.mark.parametrize("b", [32, 64, 128, 256])
def test_k8_schedule_mirror_is_bitwise(b, kind):
    """K8's reordering (only the lower trailing triangle updated; W after
    L, column by column, the absent leaves as (+0, +0) constants and the
    subtrees without a leaf skipped) gives panel_factor_ref's L and W bit
    for bit, signed zeros and NaN positions included, at every B the kernel
    is built for (1 to 8 leaf slots a lane)."""
    rng = np.random.default_rng(100 + b)
    a = _panel_kinds(rng, b)[kind]
    ph, pl = (torch.as_tensor(x) for x in _dd(a))
    got = _k8_mirror(ph, pl)
    want = tdc.panel_factor_ref(ph, pl)
    assert all(_bits(g, w) for g, w in zip(got, want))
    assert bool(torch.isnan(want[2]).any()) == (kind == "indefinite")


@pytest.mark.cuda
def test_k8_matches_its_plain_version_on_the_card():
    """K8 (csrc/dd_panel.cu) against panel_factor_ref on the card, bit for
    bit, at B = 32, 64, 128 and 256 on the four panel kinds, and a fleet of
    the four at each B (one indefinite), one launch each; a B that K8 is not
    built for raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(21)
    for b in tdc.KERNEL_BLOCKS:
        mats = np.stack(list(_panel_kinds(rng, b).values()))
        ph, pl = (torch.as_tensor(x, device="cuda") for x in _dd(mats))
        for h, l in [(ph[i], pl[i]) for i in range(len(mats))] + [(ph, pl)]:
            before = tdc.PANEL_LAUNCHES
            got = tdc.panel_factor(h, l)
            assert tdc.PANEL_LAUNCHES == before + 1
            want = tdc.panel_factor_ref(h, l)
            assert all(_bits(g.cpu(), w.cpu()) for g, w in zip(got, want)), b
    with pytest.raises(ValueError):
        tdc.panel_factor(ph[0, :48, :48], pl[0, :48, :48])

