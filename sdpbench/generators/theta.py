"""Lovász theta number of a random graph (SDPLIB's theta family).

    min <-J, X>  s.t.  tr(X) = 1,  X_ij + X_ji = 0 for every edge (i, j),  X >= 0

m = 1 + n_edges: constraint 1 is the identity, the others
``e_i e_j' + e_j e_i'``.  A frozen copy of ``theta_sdpa`` of
``hdsdp_tpu_torch/models/synthetic.py``: the same arrays bit for bit
(``tests/test_sdpbench_generators.py``).
"""

from __future__ import annotations

import numpy as np

from sdpbench.sdpa import Block, SDPData


def generate(seed, n: int = 300, n_edges: int = 4374) -> SDPData:
    rng = np.random.default_rng(seed)
    max_edges = n * (n - 1) // 2
    n_edges = min(n_edges, max_edges)
    flat = rng.choice(max_edges, size=n_edges, replace=False)
    iu, ju = np.triu_indices(n, 1)
    ei, ej = iu[flat], ju[flat]  # ei < ej
    m = 1 + n_edges
    b = np.zeros(m)
    b[0] = 1.0
    il, jl = np.tril_indices(n)
    d = np.arange(n, dtype=np.int32)
    blk = Block(
        dim=n,
        con=np.concatenate([np.zeros(len(il), np.int32), np.full(n, 1, np.int32),
                            np.arange(2, m + 1, dtype=np.int32)]),
        row=np.concatenate([il.astype(np.int32), d, ej.astype(np.int32)]),
        col=np.concatenate([jl.astype(np.int32), d, ei.astype(np.int32)]),
        val=np.concatenate([np.full(len(il), -1.0), np.ones(n), np.ones(n_edges)]),
    )
    return SDPData(m=m, b=b, blocks=[blk])
