"""Row-sharded Jacobi-preconditioned CG over a mesh (port of the JAX
package's parallel/cg.py).

For m large enough that the m x m Schur factorization dominates, the KKT
solve distributes: M's rows are sharded over the mesh, each rank computes
its rows of the matvec, and one all_gather per step makes the direction's
image whole.  The scalar reductions ride the replicated vectors, so every
rank takes the same exit at the same step.  (SURVEY.md section 5: the
distributed-communication design the reference lacks.)
"""

from __future__ import annotations

import torch

from hdsdp_tpu_torch.parallel.schur import RowShard
from hdsdp_tpu_torch.utils.device import jdtype


def sharded_pcg(mesh, M, rhs: torch.Tensor, max_iter: int = 200,
                abs_tol: float = 1e-08, rel_tol: float = 1e-08):
    """Solve M x = rhs with Jacobi-PCG, M row-sharded over the mesh (a
    RowShard, or a replicated tensor of which each rank takes its rows,
    padded to a multiple of the mesh size with an identity tail: padding
    rows solve to 0).  rhs [k] with k <= the padded size.  Returns
    (x [k] replicated, steps).

    As in the JAX package, the run stops at the tolerance, at ``max_iter``
    steps or on a NaN residual, and the caller is not told which."""
    if not isinstance(M, RowShard):
        M = RowShard.from_full(mesh, M)
    k = rhs.shape[0]
    # float32 and float64 operands (Params.dtype) meet in float64, as the
    # JAX package's promotion has them
    dt = jdtype(rhs, M.local)
    rhs = torch.nn.functional.pad(rhs.to(dt), (0, M.n - k))
    diag = M.diag().to(dt)
    local = M.local.to(dt)

    def matvec(v):
        return mesh.all_gather(local @ v)

    rhs_norm = torch.linalg.vector_norm(rhs)
    tol = torch.clamp(torch.clamp(rhs_norm * rel_tol, max=abs_tol), min=0.1 * abs_tol)
    x = torch.zeros_like(rhs)
    r = rhs
    z = r / diag
    d = z
    Md = matvec(d)
    it = 0
    done = bool(torch.linalg.vector_norm(r) < tol)
    while not done:
        rz = z @ r
        alpha = rz / (d @ Md)
        x = x + alpha * d
        r = r - alpha * Md
        z = r / diag
        beta = (r @ z) / rz
        d = z + beta * d
        Md = matvec(d)
        rn = torch.linalg.vector_norm(r)
        it += 1
        done = it >= max_iter or bool((rn < tol) | (rn != rn))
    return x[:k], it
