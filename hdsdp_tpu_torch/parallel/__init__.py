"""Multi-device distribution layer on ``torch.distributed`` (port of the
JAX package's parallel/).

The scalable dimensions of the workload are the constraint rows m (rows
of the Schur complement M), the coefficient slots inside each block group
and the cone blocks.  The mesh path shards the WORK of the hot loop (the
Schur assembly) and the m x m system over a 1-D mesh of ranks, one
process each (SPMD; the JAX package is single-controller):

  mesh.py   the process group, the four collectives, ``spawn``
  schur.py  RowShard; the row-sharded and slot-partitioned cone systems;
            the sharded matrix-free operator
  dchol.py  the distributed blocked Cholesky and its solves
  cg.py     the row-sharded Jacobi-PCG
  dryrun.py one full sharded KKT iteration per path (the counterpart of
            __graft_entry__.dryrun_multichip)
  run.py    what a rank of a spawned world runs: solves and checks

``HDSDPSolver(prob, mesh=make_mesh(device))`` takes the mesh path.
"""

from hdsdp_tpu_torch.parallel.mesh import Mesh, make_mesh, spawn

__all__ = ["Mesh", "make_mesh", "spawn"]
