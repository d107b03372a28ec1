"""SDPA sparse-format (.dat-s) reader.

Semantics follow the reference reader ``HReadSDPA``
(ref interface/hdsdp_file_io.c:34-381):

  * leading lines starting with '*' or '"' are comments,
  * first data line: number of constraints m,
  * second: number of blocks,
  * third: block dimensions (may contain {} () ' , separators); a *negative*
    dimension denotes an LP (diagonal) block, only one is supported and it
    must come last (ref hdsdp_file_io.c:110-137),
  * next: m values of the dual objective / primal RHS b (may span lines),
  * rest: entries ``<con> <blk> <i> <j> <val>`` (1-based); constraint index 0
    is the objective block, whose entries are *negated* on input
    (ref hdsdp_file_io.c:234-250, HDSDP solves min <C,X>),
  * entries with |val| < 1e-12 are dropped (ref hdsdp_file_io.c:224-230).

A path is read by the C++ tokenizer of ``hdsdp_tpu_torch/native``, a buffer
by the pure-Python parser here; both give the same arrays.
"""

from __future__ import annotations

import io
import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from hdsdp_tpu_torch.utils import profile

TINY_ENTRY = 1e-12


@dataclass
class BlockEntries:
    """COO entries of one SDP block across all constraints.

    ``con`` is 0-based with 0 = objective (already negated); SDP entries are
    normalized to the lower triangle (i >= j)."""

    dim: int
    con: np.ndarray  # int32 [nnz]
    row: np.ndarray  # int32 [nnz], row >= col
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float64 [nnz]


@dataclass
class LPEntries:
    """Entries of the LP (diagonal) block: variable index per constraint."""

    ncols: int
    con: np.ndarray  # int32 [nnz]
    var: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float64 [nnz]


@dataclass
class SDPAData:
    m: int
    block_dims: List[int]  # SDP block dims (LP block excluded)
    b: np.ndarray  # [m] dual objective / primal rhs
    blocks: List[BlockEntries] = field(default_factory=list)
    lp: Optional[LPEntries] = None
    nnz: int = 0


_SEP_RE = re.compile(r"[{}(),']")


def _tokenize_header_ints(line: str) -> List[int]:
    return [int(float(t)) for t in _SEP_RE.sub(" ", line).split()]


def write_sdpa(data: SDPAData, path_or_buf) -> None:
    """Write ``SDPAData`` back out as an SDPA sparse (.dat-s) file.

    Inverse of :func:`read_sdpa`: objective (con=0) entries are re-negated
    on output (the reader negated them, ref hdsdp_file_io.c:234-250), and
    an LP block is emitted as a trailing negative-dimension diagonal block.
    Used to hand instances to other SDPA-format solvers (e.g. the reference
    binary) for cross-validation and benchmarking.
    """

    own = not hasattr(path_or_buf, "write")
    f = open(path_or_buf, "w") if own else path_or_buf
    try:
        dims = list(data.block_dims) + ([-data.lp.ncols] if data.lp else [])
        f.write(f"{data.m}\n{len(dims)}\n")
        f.write(" ".join(str(d) for d in dims) + "\n")
        f.write(" ".join(repr(float(v)) for v in data.b) + "\n")
        for j, blk in enumerate(data.blocks):
            sgn = np.where(blk.con == 0, -1.0, 1.0)
            for c, r, cc, v in zip(blk.con, blk.row, blk.col, sgn * blk.val):
                # reader normalized to row >= col; SDPA wants i <= j
                f.write(f"{c} {j + 1} {cc + 1} {r + 1} {float(v)!r}\n")
        if data.lp is not None:
            sgn = np.where(data.lp.con == 0, -1.0, 1.0)
            jb = len(data.blocks) + 1
            for c, i, v in zip(data.lp.con, data.lp.var, sgn * data.lp.val):
                f.write(f"{c} {jb} {i + 1} {i + 1} {float(v)!r}\n")
    finally:
        if own:
            f.close()


def read_sdpa(path_or_buf) -> SDPAData:
    """Read an SDPA sparse file into raw per-block COO arrays.

    A path is read by the native tokenizer (``native/sdpa_parser.cpp``,
    built with g++ on first use); a buffer (anything with ``read``) by the
    Python parser below.  Both give the same arrays, and both raise on a
    malformed file: neither falls back to the other."""
    with profile.span("read_sdpa"):
        return _read_sdpa(path_or_buf)


def _read_sdpa(path_or_buf) -> SDPAData:
    if not hasattr(path_or_buf, "read"):
        from hdsdp_tpu_torch.native import sdpa_native

        m, dims, b, con, blk, row, col, val = sdpa_native.parse(str(path_or_buf))
        return _assemble(m, [int(d) for d in dims], b, con, blk, row, col, val)

    lines = path_or_buf.read().splitlines()
    k = 0

    # Comments
    while k < len(lines) and (not lines[k].strip() or lines[k][0] in "*\""):
        k += 1
    m = int(lines[k].split()[0])
    k += 1
    nblocks = int(lines[k].split()[0])
    k += 1

    # Block dims: usually one line but tolerate spanning several
    dims: List[int] = []
    while len(dims) < nblocks and k < len(lines):
        dims.extend(_tokenize_header_ints(lines[k]))
        k += 1
    dims = dims[:nblocks]

    # RHS: m floats possibly spanning lines, commas/braces tolerated
    rhs: List[float] = []
    while len(rhs) < m and k < len(lines):
        rhs.extend(float(t) for t in _SEP_RE.sub(" ", lines[k]).split())
        k += 1
    b = np.asarray(rhs[:m], dtype=np.float64)

    # Entries: 5 columns per line
    body = "\n".join(lines[k:])
    # Filter trailing comment sections
    cut = body.find("BEGIN.COMMENT")
    if cut >= 0:
        body = body[:cut]
    if body.strip():
        arr = np.loadtxt(io.StringIO(body), ndmin=2)
        if arr.shape[1] != 5:
            raise ValueError("malformed SDPA entry line")
    else:
        arr = np.zeros((0, 5))

    con = arr[:, 0].astype(np.int64)
    blk = arr[:, 1].astype(np.int64) - 1
    row = arr[:, 2].astype(np.int64) - 1
    col = arr[:, 3].astype(np.int64) - 1
    val = arr[:, 4].astype(np.float64)
    return _assemble(m, dims, b, con, blk, row, col, val)


def _assemble(m, dims, b, con, blk, row, col, val) -> SDPAData:
    """``SDPAData`` from the parsed header and entries (0-based blk, row and
    col; objective not yet negated), shared by both parsers."""
    nblocks = len(dims)
    lp_cols = 0
    sdp_dims = []
    for idx, d in enumerate(dims):
        if d < 0:
            # Only one diagonal block, at the end (ref hdsdp_file_io.c:110-116)
            if idx != nblocks - 1:
                raise ValueError("LP (negative) block must be the last block")
            lp_cols = -d
        elif d == 0:
            raise ValueError("zero block dimension")
        else:
            sdp_dims.append(d)
    if lp_cols and len(sdp_dims) != nblocks - 1:
        raise ValueError("only one LP block supported")

    keep = np.abs(val) >= TINY_ENTRY
    con, blk, row, col, val = con[keep], blk[keep], row[keep], col[keep], val[keep]
    # Objective entries are negated (ref hdsdp_file_io.c:234-250)
    val = np.where(con == 0, -val, val)

    nsdp = len(sdp_dims)
    data = SDPAData(m=m, block_dims=sdp_dims, b=b, nnz=int(keep.sum()))

    for j in range(nsdp):
        sel = blk == j
        r, c = row[sel], col[sel]
        # normalize to lower triangle (ref hdsdp_file_io.c:242-246)
        lo = np.maximum(r, c).astype(np.int32)
        hi = np.minimum(r, c).astype(np.int32)
        data.blocks.append(
            BlockEntries(
                dim=sdp_dims[j],
                con=con[sel].astype(np.int32),
                row=lo,
                col=hi,
                val=val[sel],
            )
        )

    if lp_cols:
        sel = blk == nsdp
        data.lp = LPEntries(
            ncols=lp_cols,
            con=con[sel].astype(np.int32),
            var=row[sel].astype(np.int32),
            val=val[sel],
        )

    return data
