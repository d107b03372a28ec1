"""What a rank of a spawned world runs (``parallel.mesh.spawn`` needs its
functions importable by the children, so they live in the package).

    spawn(run.calls, 4, "gloo", "cpu", [("solve", {...}), ("kkt", {...})])

``calls`` runs a list of named bodies on one world and returns their
results in order (rank 0's; every body gathers what it reports from the
other ranks).  The bodies build their inputs from a synthetic generator
and a seed on every rank alike and return numpy arrays and numbers:

  solve    HDSDPSolver(prob, mesh=mesh, **overrides).optimize(): status,
           iterations, objectives, DIMACS, stats, the iteration log's
           rows (``log_rows``), every rank's y and
           whether they agree bit for bit, the collectives' counts, the
           K1/K1s launches and the K8 launches (rank 0's, and every rank's
           (K1, K1s, K8)), wall and peak device memory
  kkt      one cone system's assemble + factor + build_kkt of each kind,
           M gathered from the shards, the rows each rank held
  cone_factor  one rank's cone factor of a single-block S with
           ``cone_dd`` against the single-device ``ConeSystem``'s
  dchol    sharded_cholesky / sharded_chol_solve of a given matrix
  pcg      sharded_pcg of a given matrix
  matvec   the sharded operator matvec against the single-device one
  dryrun   parallel.dryrun.dryrun(mesh)
  collectives  each of the mesh's collectives on rank-seeded inputs,
           against the result every rank can compute from all the inputs
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from hdsdp_tpu_torch.models import synthetic
from hdsdp_tpu_torch.models.problem import SDPProblem


def _np(t):
    return t.detach().cpu().numpy()


def problem(gen, kwargs: dict) -> SDPProblem:
    """The problem of a generator of models.synthetic by name, or of an
    ``SDPAData`` given as it is (``kwargs`` then unused)."""
    data = getattr(synthetic, gen)(**kwargs) if isinstance(gen, str) else gen
    return SDPProblem.from_sdpa(data)


@contextlib.contextmanager
def log_rows(logger_cls):
    """Record every iteration-log row that ``logger_cls`` (either
    package's ``utils.log.Logger``) is given while the block runs, printed
    or not, as (method, iteration, d_obj, mu, step) in a list."""
    rows = []
    show = logger_cls.iter_row

    def iter_row(self, method, n, pobj, dobj, inf, mu, step, extra, t):
        rows.append((method, int(n), float(dobj), float(mu), float(step)))
        show(self, method, n, pobj, dobj, inf, mu, step, extra, t)

    logger_cls.iter_row = iter_row
    try:
        yield rows
    finally:
        logger_cls.iter_row = show


def _gathered(mesh, t: torch.Tensor):
    """[size, ...] of every rank's t, and whether all are bit-equal."""
    allt = mesh.all_gather(t.reshape(1, -1).contiguous())
    same = all(torch.equal(allt[0], allt[i]) for i in range(1, allt.shape[0]))
    return allt, same


def solve(mesh, gen: str, kwargs: dict, overrides: dict, repeat: int = 1):
    from hdsdp_tpu_torch.ops import ddchol, hpmm
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver
    from hdsdp_tpu_torch.utils.log import Logger

    prob = problem(gen, kwargs)
    cuda = mesh.device.type == "cuda"
    out = []
    for _ in range(repeat):
        mesh.reset_counts()
        hpmm.KERNEL_LAUNCHES = hpmm.SLICE_LAUNCHES = ddchol.PANEL_LAUNCHES = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = HDSDPSolver(prob, mesh=mesh, verbose=False, **overrides)
        with log_rows(Logger) as rows:
            r = s.optimize()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(mesh.counts)
        launches = (hpmm.KERNEL_LAUNCHES, hpmm.SLICE_LAUNCHES)
        k8_launches = ddchol.PANEL_LAUNCHES
        per_rank, _ = _gathered(mesh, torch.tensor([*launches, k8_launches],
                                                   dtype=torch.float64, device=mesh.device))
        ys, same_y = _gathered(mesh, torch.as_tensor(r.y, dtype=torch.float64,
                                                     device=mesh.device))
        _, same_obj = _gathered(mesh, torch.tensor([r.d_obj, r.p_obj], dtype=torch.float64,
                                                   device=mesh.device))
        ipm = s.ipm
        out.append({
            "status": r.status, "iterations": r.n_iters, "d_obj": r.d_obj, "p_obj": r.p_obj,
            "dimacs": np.asarray(r.dimacs), "stats": r.stats, "y": r.y, "log_rows": rows,
            "y_all_ranks": _np(ys), "same_y": same_y, "same_obj": same_obj,
            "cones": type(ipm.cones).__name__, "which_method": ipm.which_method,
            "psdp": ipm.psdp is not None and ipm.psdp.X is not None,
            "kkt_free": ipm.kkt_free, "counts": counts,
            "launches": launches, "k8_launches": k8_launches,
            "launches_by_rank": _np(per_rank).astype(int).tolist(), "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
            "size": mesh.size, "device": str(mesh.device),
        })
    return out if repeat > 1 else out[0]


def kkt(mesh, gen: str, kwargs: dict, system: str, seed: int = 11, Rd: float = -1.3,
        kkt_hp: bool = False):
    """``system`` "sharded" or "row"; y ~ 0.01 N(0, 1) from ``seed``, the
    shift 10 + ||C||_F as in the JAX package's tests."""
    from hdsdp_tpu_torch.parallel.schur import RowShardedConeSystem, ShardedConeSystem

    prob = problem(gen, kwargs)
    cls = ShardedConeSystem if system == "sharded" else RowShardedConeSystem
    cones = cls(prob, mesh)
    cones.kkt_hp = kkt_hp
    y = torch.as_tensor(np.random.default_rng(seed).normal(size=prob.m) * 0.01,
                        device=mesh.device)
    shift = 10.0 + prob.features.obj_fro_norm
    S, s_lp = cones.assemble(1.0, -1.0, y, shift)
    ok, L = cones.factor(S, s_lp)
    res = {"ok": bool(ok), "S": [_np(Sg) for Sg in S], "m_pad": cones.m_pad,
           "s_lp": None if s_lp is None else _np(s_lp)}
    for kind in ("hsd", "inf", "corr"):
        k = cones.build_kkt(L, s_lp, Rd, kind)
        d = {f: (None if getattr(k, f) is None else _np(getattr(k, f)))
             for f in ("asinv", "asinvrdsinv", "asinvcsinv", "csinv", "csinvcsinv",
                       "csinvrdsinv", "trace_sinv")}
        if k.M is not None:
            rows = mesh.all_gather(torch.tensor([k.M.mloc], device=mesh.device))
            d["M"] = _np(k.M.gather())
            d["rows_per_rank"] = _np(rows).tolist()
        res[kind] = d
    return res


def cone_factor(mesh, gen: str, kwargs: dict, seed: int = 11):
    """The row-sharded system's cone factor with ``cone_dd`` (the DD
    blocked Cholesky for a single block of n >= 512) on this rank, at a
    point y ~ 0.01 N(0, 1) from ``seed``, against the single-device
    ``ConeSystem``'s factor of the same S: whether the two agree bit for
    bit on every rank, and whether the factor differs from the f64
    Cholesky of S (so that the DD branch ran)."""
    from hdsdp_tpu_torch.parallel.schur import RowShardedConeSystem
    from hdsdp_tpu_torch.solver.cones import ConeSystem

    prob = problem(gen, kwargs)
    y = torch.as_tensor(np.random.default_rng(seed).normal(size=prob.m) * 0.01,
                        device=mesh.device)
    shift = 10.0 + prob.features.obj_fro_norm
    out = []
    for cones in (RowShardedConeSystem(prob, mesh), ConeSystem(prob, mesh.device)):
        cones.cone_dd = True
        S, s_lp = cones.assemble(1.0, -1.0, y, shift)
        ok, L = cones.factor(S, s_lp)
        out.append((bool(ok), S, L))
    (ok_m, S_m, L_m), (ok_s, S_s, L_s) = out
    same = torch.equal(S_m[0], S_s[0]) and torch.equal(L_m[0], L_s[0])
    _, same_all = _gathered(mesh, torch.tensor([float(same)], device=mesh.device))
    return {"ok": ok_m and ok_s, "same": same and same_all, "n": S_m[0].shape[-1],
            "differs_from_f64": not torch.equal(L_m[0], torch.linalg.cholesky(S_m[0]))}


def dchol(mesh, M: np.ndarray, rhs: np.ndarray, bad: np.ndarray, block: int):
    from hdsdp_tpu_torch.parallel.dchol import sharded_chol_solve, sharded_cholesky

    dev = mesh.device
    fac = sharded_cholesky(mesh, torch.as_tensor(M, device=dev), block=block)
    b = torch.as_tensor(rhs, device=dev)
    x = sharded_chol_solve(fac, b)
    x1 = sharded_chol_solve(fac, b[:, 0])
    badf = sharded_cholesky(mesh, torch.as_tensor(bad, device=dev), block=block)
    return {"ok": fac.ok, "L": _np(fac.gather_L()), "x": _np(x), "x1": _np(x1),
            "bad_ok": badf.ok, "mp": fac.mp, "m": fac.m, "rows": fac.L.shape[0]}


def pcg(mesh, M: np.ndarray, rhs: np.ndarray, **kw):
    from hdsdp_tpu_torch.parallel.cg import sharded_pcg

    dev = mesh.device
    x, it = sharded_pcg(mesh, torch.as_tensor(M, device=dev), torch.as_tensor(rhs, device=dev),
                        **kw)
    return {"x": _np(x), "iters": it}


def matvec(mesh, gen: str, kwargs: dict, system: str, seed: int = 3, k: int = 2):
    """The sharded operator matvec at a random interior point against the
    single-device per-group ``group_schur_matvec`` on the same groups."""
    from hdsdp_tpu_torch.ops import schur as schur_ops
    from hdsdp_tpu_torch.parallel.schur import RowShardedConeSystem, ShardedConeSystem

    prob = problem(gen, kwargs)
    cls = ShardedConeSystem if system == "sharded" else RowShardedConeSystem
    cones = cls(prob, mesh)
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.normal(size=prob.m) * 0.01, device=mesh.device)
    S, s_lp = cones.assemble(1.0, -1.0, y, 10.0 + prob.features.obj_fro_norm)
    ok, L = cones.factor(S, s_lp)
    Us = cones.inverses(L)
    V = torch.as_tensor(rng.normal(size=(prob.m, k)), device=mesh.device)
    extra = torch.as_tensor(rng.random(prob.m), device=mesh.device)
    got = cones.kkt_matvec(Us, s_lp, extra, V)
    cols = []
    for v in V.unbind(1):
        o = extra * v
        for ga, U in zip(cones.groups, Us):
            o = o + schur_ops.group_schur_matvec(ga, U, v, prob.m)
        if cones.lp is not None:
            o = o + schur_ops.lp_schur_matvec(cones.lp, s_lp, v)
        cols.append(o)
    return {"ok": bool(ok), "sharded": _np(got), "single": _np(torch.stack(cols, 1)),
            "counts": dict(mesh.counts)}


def collectives(mesh):
    """Each collective on inputs seeded by the rank, against what it must
    give (every rank can make every rank's inputs): per collective,
    whether the result is bit-equal to that, and the counts."""
    def inputs(r):
        g = torch.Generator().manual_seed(r)
        return torch.randn((2 * mesh.size, 3), generator=g, dtype=torch.float64)

    xs = [inputs(r) for r in range(mesh.size)]
    x = xs[mesh.rank].to(mesh.device)
    k = 2  # rows of x per rank in reduce_scatter's result
    # sums in rank order: what a reduction of two or more terms must not
    # be held to bit for bit, so those are held on one nonzero term each
    one = [torch.where((torch.arange(2 * mesh.size) % mesh.size == r)[:, None], xs[r], 0.0)
           for r in range(mesh.size)]
    want = {
        "all_reduce": sum(one),
        "all_reduce_max": torch.stack(xs).amax(0),
        "all_reduce_min": torch.stack(xs).amin(0),
        "all_gather": torch.cat(xs),
        "reduce_scatter": sum(one)[mesh.rank * k:(mesh.rank + 1) * k],
        "broadcast": xs[mesh.size - 1],
    }
    mine = one[mesh.rank].to(mesh.device)
    mesh.reset_counts()
    got = {
        "all_reduce": mesh.all_reduce(mine),
        "all_reduce_max": mesh.all_reduce(x, op="max"),
        "all_reduce_min": mesh.all_reduce(x, op="min"),
        "all_gather": mesh.all_gather(x),
        "reduce_scatter": mesh.reduce_scatter(mine),
        "broadcast": mesh.broadcast(x, mesh.size - 1),
    }
    return {"same": {n: torch.equal(got[n].cpu(), want[n]) for n in want},
            "counts": dict(mesh.counts)}


def dryrun(mesh):
    from hdsdp_tpu_torch.parallel.dryrun import dryrun as run

    return run(mesh)


BODIES = {"solve": solve, "kkt": kkt, "cone_factor": cone_factor, "dchol": dchol, "pcg": pcg,
          "matvec": matvec, "dryrun": dryrun, "collectives": collectives}


def calls(mesh, todo):
    """Run [(body name, kwargs), ...] in order on this world; a list of
    their results (rank 0's)."""
    return [BODIES[name](mesh, **kw) for name, kw in todo]
