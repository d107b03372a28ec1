"""Distributed blocked Cholesky of the row-sharded Schur complement (port
of the JAX package's parallel/dchol.py).

The reference factors the m x m Schur matrix with one LAPACK dpotrf (ref
linalg/hdsdp_linsolver.c:1044-1286).  Here M's rows are sharded over the
mesh and the factorization is right-looking and blocked; per panel of
``block`` columns the only communication is

  * one broadcast of the B x B diagonal block from the rank that owns it
    (every rank then factors it, redundantly: O(B^3) is negligible),
  * one all_gather of the panel column [mp, B] for the trailing update,

O(m^2) in all, the order of gathering M once; no rank ever holds the
whole matrix.  The triangular solves run panel by panel with one
collective per panel each way.

The size is padded to a multiple of ``size * block`` with an identity
tail (``_padded_size``), so that panels never straddle ranks: rank d owns
rows [d * mp / size, (d + 1) * mp / size).  A ``RowShard`` whose row
blocks differ from that layout is moved into it first (one broadcast per
source rank, a block of rows at a time).  The B x B blocks are factored
and solved with ``torch.linalg.cholesky_ex`` and ``solve_triangular``.
"""

from __future__ import annotations

import torch

from hdsdp_tpu_torch.parallel.schur import RowShard
from hdsdp_tpu_torch.utils.device import jdtype


def _padded_size(m: int, ndev: int, block: int) -> int:
    unit = ndev * block
    return max(-(-m // unit) * unit, unit)


class ShardedCholFactor:
    """This rank's rows of L plus the layout; ``ok`` is the NaN predicate,
    the same on every rank.  ``m`` is the size of the factored matrix (the
    padded KKT size when it came from a cone system), ``mp`` its padded
    size.  ``Lp`` holds every panel's diagonal block on every rank."""

    def __init__(self, L, Lp, ok, m, mp, mesh, block):
        self.L = L  # [mp / size, mp]
        self.Lp = Lp  # [mp / block, block, block]
        self.ok = ok
        self.m = m
        self.mp = mp
        self.mesh = mesh
        self.block = block

    def gather_L(self) -> torch.Tensor:
        """The whole [mp, mp] factor (for checks)."""
        return self.mesh.all_gather(self.L)


def _to_layout(M: RowShard, mp: int) -> torch.Tensor:
    """This rank's rows of the [mp, mp] identity-tailed extension of M in
    the factor's layout ([mp / size, mp])."""
    mesh = M.mesh
    size, rank = mesh.size, mesh.rank
    mloc2 = mp // size
    lo, hi = rank * mloc2, (rank + 1) * mloc2
    out = torch.zeros((mloc2, mp), dtype=M.local.dtype, device=M.local.device)
    if M.row0 == lo and M.mloc == mloc2:
        out[:, :M.n] = M.local
    else:
        for src in range(size):
            s0 = src * M.mloc
            blk = mesh.broadcast(M.local, src)
            a, b = max(lo, s0), min(hi, s0 + M.mloc, M.n)
            if a < b:
                out[a - lo:b - lo, :M.n] = blk[a - s0:b - s0]
    tail = torch.arange(max(lo, M.n), max(hi, M.n), device=out.device)
    out[tail - lo, tail] = 1.0
    return out


def sharded_cholesky(mesh, M, block: int = 128) -> ShardedCholFactor:
    """Factor an SPD matrix with rows sharded over the mesh: ``M`` a
    RowShard, or a replicated tensor (each rank takes its rows).

    ``ok`` is False (NaN-propagated) if M is not positive definite, the
    same predicate as HFpLinsysPsdCheck (ref hdsdp_linsolver.c:1112-1144),
    all-reduced so that every rank reads the same."""
    if not isinstance(M, RowShard):
        M = RowShard.from_full(mesh, M)
    size, rank = mesh.size, mesh.rank
    m = M.n
    B = min(block, max(8, m))
    mp = _padded_size(m, size, B)
    A = _to_layout(M, mp)
    mloc = mp // size
    ppd = mloc // B  # panels per rank
    npanels = mp // B
    dt, dev = A.dtype, A.device
    grow = rank * mloc + torch.arange(mloc, device=dev)  # global rows held here
    L = torch.zeros_like(A)
    eye = torch.eye(B, dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    Lps = []
    for p in range(npanels):
        col = p * B
        owner, rid = p // ppd, (p % ppd) * B
        mine = rank == owner
        D = A[rid:rid + B, col:col + B] if mine else torch.zeros((B, B), dtype=dt, device=dev)
        D = mesh.broadcast(D, owner)
        # every rank factors the block (jnp.linalg.cholesky symmetrizes)
        Lp, info = torch.linalg.cholesky_ex(0.5 * (D + D.mT))
        Lp = torch.where(info == 0, Lp, nan)
        Lps.append(Lp)
        LpinvT = torch.linalg.solve_triangular(Lp, eye, upper=False).mT
        G = A[:, col:col + B] @ LpinvT  # candidate panel column of the local rows
        G = torch.where((grow >= col + B)[:, None], G, 0.0)
        L[:, col:col + B] = G
        if mine:
            L[rid:rid + B, col:col + B] = Lp
        # trailing update: the gathered column is zero in and above the
        # panel, so the full-width product touches the trailing block only
        Gfull = mesh.all_gather(G)  # [mp, B]
        A = A - G @ Gfull.mT
    # NaN predicate (arithmetic form: a NaN anywhere makes the sum NaN)
    ok_loc = (torch.sum(L - L) == 0.0).to(torch.int32).reshape(1)
    ok = bool(mesh.all_reduce(ok_loc, op="min")[0])
    return ShardedCholFactor(L, torch.stack(Lps), ok, m, mp, mesh, B)


def sharded_chol_solve(fac: ShardedCholFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M x = rhs (rhs [k] or [k, r], replicated, k <= mp: the rows
    past k are the identity tail's) against a sharded factor; x is
    replicated."""
    mesh = fac.mesh
    size, rank = mesh.size, mesh.rank
    single = rhs.ndim == 1
    # float32 and float64 operands (Params.dtype) solve in float64, as
    # the JAX package's promotion has them
    dt = jdtype(rhs, fac.L)
    b = (rhs[:, None] if single else rhs).to(dt)
    k = b.shape[0]
    b = torch.nn.functional.pad(b, (0, 0, 0, fac.mp - k))
    B, mp = fac.block, fac.mp
    mloc = mp // size
    ppd = mloc // B
    npanels = mp // B
    L, Lp = fac.L.to(dt), fac.Lp.to(dt)
    grow = rank * mloc + torch.arange(mloc, device=L.device)

    # forward: L y = b; the panel's owner solves its block, then broadcasts
    x = torch.zeros_like(b)
    for p in range(npanels):
        col = p * B
        owner, rid = p // ppd, (p % ppd) * B
        if rank == owner:
            t = L[rid:rid + B, :col] @ x[:col]
            xp = torch.linalg.solve_triangular(Lp[p], b[col:col + B] - t, upper=False)
        else:
            xp = torch.zeros((B, b.shape[1]), dtype=b.dtype, device=b.device)
        x[col:col + B] = mesh.broadcast(xp, owner)

    # backward: L^T x = y; the partial products over the rows below the
    # panel are all-reduced, and every rank solves the block alike
    for q in range(npanels):
        p = npanels - 1 - q
        col = p * B
        Lcols = torch.where((grow >= col + B)[:, None], L[:, col:col + B], 0.0)
        t = mesh.all_reduce(Lcols.mT @ x[rank * mloc:(rank + 1) * mloc])
        x[col:col + B] = torch.linalg.solve_triangular(
            Lp[p].mT, x[col:col + B] - t, upper=True)
    x = x[:k]
    return x[:, 0] if single else x
