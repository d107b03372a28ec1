"""One full sharded KKT iteration on each mesh path (the counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip``): dual-slack
assembly -> batched Cholesky -> sharded Schur assembly -> distributed
Schur factorization -> 3 KKT solves -> step direction.

  path 1  theta_sdpa(n=64, n_edges=511, seed=3), m = 512: the row-sharded
          system (bounded-support bucket + a dense identity row), M born
          row-sharded and factored by the distributed blocked Cholesky;
  path 2  random_sdpa(m=24, block_dims=[8, 8, 6], n_lp=4, seed=2): the
          slot-partitioned system (multi-block groups + the LP cone), M
          reduce-scattered into row blocks and factored the same way.

Each asserts that no rank holds every row of M (on a mesh of more than
one rank), that the factor succeeds and that dy is finite.  It takes a
mesh; it does not build one:

    spawn(parallel.run.calls, 4, "gloo", "cpu", [("dryrun", {})])
"""

from __future__ import annotations

import torch

from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.models.synthetic import random_sdpa, theta_sdpa


def _step(mesh, cones, prob) -> dict:
    from hdsdp_tpu_torch.parallel.dchol import sharded_chol_solve, sharded_cholesky

    m = prob.m
    dev = mesh.device
    b = torch.as_tensor(prob.b * prob.features.rhs_scaling, dtype=torch.float64, device=dev)
    y = torch.zeros(m, dtype=torch.float64, device=dev)
    rd = -float(prob.features.obj_fro_norm) - 10.0
    tau, mu, lo, up = 1.0, 1e4, -1e7, 1e7
    S, s_lp = cones.assemble(tau, -1.0, y, -rd)
    ok, L = cones.factor(S, s_lp)
    assert bool(ok), "dry run: the dual slack is not positive definite"
    kkt = cones.build_kkt(L, s_lp, rd, "inf")
    rows = [int(r) for r in mesh.all_gather(
        torch.tensor([kkt.M.mloc], device=dev)).tolist()]
    if mesh.size > 1:
        assert max(rows) < m, "a rank holds every row of M"
    # the implicit bound cone (ref hdsdp_conic_bound.c:201-248)
    li, ui = 1.0 / (y - tau * lo), 1.0 / (tau * up - y)
    M = kkt.M.plus_diag(li * li + ui * ui)
    asinv = kkt.asinv + ui - li
    fac = sharded_cholesky(mesh, M)
    assert fac.ok, "the distributed Cholesky failed on a positive definite matrix"
    sol = sharded_chol_solve(fac, torch.stack([b, asinv, kkt.asinvrdsinv], dim=1))[:m]
    dy = sol[:, 0] / mu - sol[:, 1] + sol[:, 2]
    assert bool(torch.isfinite(dy).all()), "dry run: dy is not finite"
    mesh.assert_same(dy, "dy")
    return {"m": m, "m_pad": cones.m_pad, "rows_per_rank": rows, "mp": fac.mp,
            "block": fac.block, "dy_norm": float(torch.linalg.vector_norm(dy))}


def dryrun(mesh) -> dict:
    """Both paths once on ``mesh``; returns what each saw."""
    from hdsdp_tpu_torch.parallel.schur import RowShardedConeSystem, ShardedConeSystem

    p1 = SDPProblem.from_sdpa(theta_sdpa(n=64, n_edges=511, seed=3))
    p2 = SDPProblem.from_sdpa(random_sdpa(m=24, block_dims=[8, 8, 6], n_lp=4, seed=2))
    return {
        "row_sharded": _step(mesh, RowShardedConeSystem(p1, mesh), p1),
        "slot_sharded": _step(mesh, ShardedConeSystem(p2, mesh), p2),
        "counts": dict(mesh.counts),
    }
