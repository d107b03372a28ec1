"""Max-cut relaxation of a random graph (SDPLIB's maxG family).

    min <C, X>  s.t.  X_ii = diag (i = 1..n),  X >= 0,   C = -(diag(W e) - W) / 4

A frozen copy of ``maxcut_sdpa`` and ``_maxcut_from_edges`` of
``hdsdp_tpu_torch/models/synthetic.py``, with three arguments added: the
edge count (``n_edges``, default ``n * degree // 2`` as there), the
weights (``"pm1"``, uniform on {-1, +1}, as there; ``"unit"``, all 1, as
Gset's G51) and the fixed diagonal (``diag``, default 1/4 as there; 1 in
SDPLIB's maxG files).  At the default arguments it gives that function's
arrays bit for bit (``tests/test_sdpbench_generators.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sdpbench.sdpa import Block, SDPData


def generate(seed, n: int = 1000, degree: int = 6, n_edges: Optional[int] = None,
             weights: str = "pm1", diag: float = 0.25) -> SDPData:
    rng = np.random.default_rng(seed)
    max_edges = n * (n - 1) // 2
    n_edges = min(n * degree // 2 if n_edges is None else n_edges, max_edges)
    flat = rng.choice(max_edges, size=n_edges, replace=False)
    iu, ju = np.triu_indices(n, 1)
    ei, ej = iu[flat], ju[flat]
    if weights == "pm1":
        w = rng.choice([-1.0, 1.0], size=n_edges)
    elif weights == "unit":
        w = np.ones(n_edges)
    else:
        raise ValueError(f"unknown weights {weights!r}")
    deg = np.zeros(n)
    np.add.at(deg, ei, w)
    np.add.at(deg, ej, w)
    d = np.arange(n, dtype=np.int32)
    blk = Block(
        dim=n,
        con=np.concatenate([np.zeros(n, np.int32), np.zeros(n_edges, np.int32),
                            np.arange(1, n + 1, dtype=np.int32)]),
        row=np.concatenate([d, ej.astype(np.int32), d]),
        col=np.concatenate([d, ei.astype(np.int32), d]),
        val=np.concatenate([-deg / 4.0, w / 4.0, np.ones(n)]),
    )
    return SDPData(m=n, b=np.full(n, float(diag)), blocks=[blk])
