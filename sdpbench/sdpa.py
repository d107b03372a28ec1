"""The benchmark's own SDP data: raw COO arrays in the SDPA convention, and
their writer.

An instance is ``min <C, X>  s.t.  <A_i, X> = b_i (i = 1..m),  X >= 0``
with one or more symmetric blocks.  Each block's entries are kept as
``(con, row, col, val)`` with ``row >= col`` (lower triangle), ``con = 0``
for C and ``con = i`` for A_i.  The SDPA file format stores the objective
negated (SDPA's primal is a maximisation of ``-<C, X>``), so the writer
negates the ``con = 0`` entries.  Both the program (through its reader) and
the plain reference (through these arrays) see the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class Block:
    dim: int
    con: np.ndarray  # int32 [nnz], 0 = objective
    row: np.ndarray  # int32 [nnz], row >= col
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float64 [nnz]


@dataclass
class SDPData:
    m: int
    b: np.ndarray  # float64 [m]
    blocks: List[Block] = field(default_factory=list)

    @property
    def block_dims(self) -> List[int]:
        return [blk.dim for blk in self.blocks]


def write_sdpa(data: SDPData, path: str) -> None:
    """Write ``data`` as an SDPA sparse file (``.dat-s``), every value with
    17 significant digits so that it reads back bit for bit."""
    lines = [str(data.m), str(len(data.blocks)), " ".join(str(d) for d in data.block_dims),
             " ".join(f"{float(v):.17g}" for v in data.b)]
    for j, blk in enumerate(data.blocks):
        val = np.where(blk.con == 0, -blk.val, blk.val)
        # SDPA lists the upper triangle: i <= j
        lines.extend(f"{c} {j + 1} {cc + 1} {r + 1} {float(v):.17g}"
                     for c, r, cc, v in zip(blk.con.tolist(), blk.row.tolist(),
                                            blk.col.tolist(), val.tolist()))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
