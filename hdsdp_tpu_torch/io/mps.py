"""MPS linear-program reader (free format).

Parity target: the vendored MPS reader of the reference
(ref external/lp_mps.c, entry potLpMpsRead, lp_mps.h:11-15) which feeds the
standalone LP IPM.  We parse ROWS / COLUMNS / RHS / RANGES / BOUNDS and
convert to the standard form used by hdsdp_tpu_torch.solver.lpsolve:

    min c'x  s.t.  A x = b,  x >= 0

by adding slack variables for inequality rows and splitting free / bounded
variables the usual way.  Host-side numpy; a copy of the JAX package's
reader, held to it array for array by the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class MPSData:
    name: str
    # Standard form min c'x, Ax = b, x >= 0
    ncol: int
    nrow: int
    c: np.ndarray
    # CSC of A
    col_ptr: np.ndarray
    row_idx: np.ndarray
    val: np.ndarray
    b: np.ndarray
    objsense: float = 1.0
    obj_shift: float = 0.0
    # mapping info for reporting in original variable space
    orig_ncol: int = 0
    orig_names: Optional[List[str]] = None


def _tok(line: str) -> List[str]:
    return line.split()


def read_mps(path: str) -> MPSData:
    name = ""
    section = None
    row_sense: Dict[str, str] = {}
    row_order: List[str] = []
    obj_row = None
    cols: Dict[str, List[Tuple[str, float]]] = {}
    col_order: List[str] = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    lb: Dict[str, float] = {}
    ub: Dict[str, float] = {}
    free: Dict[str, bool] = {}
    objsense = 1.0

    with open(path, "r") as f:
        for raw in f:
            if not raw.strip() or raw.startswith("*"):
                continue
            if not raw[0].isspace():
                parts = _tok(raw)
                head = parts[0].upper()
                if head == "NAME":
                    name = parts[1] if len(parts) > 1 else ""
                    section = "NAME"
                elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS"):
                    section = head
                elif head == "OBJSENSE":
                    section = "OBJSENSE"
                elif head == "ENDATA":
                    break
                else:
                    section = head
                continue

            parts = _tok(raw)
            if section == "OBJSENSE":
                objsense = -1.0 if parts[0].upper().startswith("MAX") else 1.0
            elif section == "ROWS":
                sense, rname = parts[0].upper(), parts[1]
                if sense == "N":
                    if obj_row is None:
                        obj_row = rname
                else:
                    row_sense[rname] = sense
                    row_order.append(rname)
            elif section == "COLUMNS":
                if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                    continue  # integer markers ignored (continuous relaxation)
                cname = parts[0]
                if cname not in cols:
                    cols[cname] = []
                    col_order.append(cname)
                for i in range(1, len(parts) - 1, 2):
                    cols[cname].append((parts[i], float(parts[i + 1])))
            elif section == "RHS":
                for i in range(1, len(parts) - 1, 2):
                    rhs[parts[i]] = float(parts[i + 1])
            elif section == "RANGES":
                for i in range(1, len(parts) - 1, 2):
                    ranges[parts[i]] = float(parts[i + 1])
            elif section == "BOUNDS":
                btype = parts[0].upper()
                cname = parts[2]
                bval = float(parts[3]) if len(parts) > 3 else 0.0
                if btype == "UP":
                    ub[cname] = bval
                    if bval < 0 and cname not in lb:
                        lb[cname] = -np.inf
                elif btype == "LO":
                    lb[cname] = bval
                elif btype == "FX":
                    lb[cname] = bval
                    ub[cname] = bval
                elif btype == "FR":
                    free[cname] = True
                elif btype == "MI":
                    lb[cname] = -np.inf
                elif btype == "PL":
                    ub[cname] = np.inf
                elif btype == "BV":
                    lb[cname] = 0.0
                    ub[cname] = 1.0
                elif btype in ("UI",):
                    ub[cname] = bval
                elif btype in ("LI",):
                    lb[cname] = bval

    nrow = len(row_order)
    row_id = {r: i for i, r in enumerate(row_order)}

    # Assemble in intermediate form: l <= x <= u, sense rows
    ncol0 = len(col_order)
    col_id = {cname: j for j, cname in enumerate(col_order)}
    c0 = np.zeros(ncol0)
    entries_i: List[int] = []
    entries_j: List[int] = []
    entries_v: List[float] = []
    for cname in col_order:
        j = col_id[cname]
        for rname, v in cols[cname]:
            if rname == obj_row:
                c0[j] += v
            elif rname in row_id:
                entries_i.append(row_id[rname])
                entries_j.append(j)
                entries_v.append(v)

    b0 = np.array([rhs.get(r, 0.0) for r in row_order])

    # Variable bounds
    lower = np.array([lb.get(cname, 0.0) for cname in col_order])
    upper = np.array([ub.get(cname, np.inf) for cname in col_order])
    for cname, isfree in free.items():
        if isfree and cname in col_id:
            lower[col_id[cname]] = -np.inf
            upper[col_id[cname]] = np.inf

    # Convert to standard form: shift lower bounds, split free vars,
    # add slacks for L/G rows and for finite upper bounds / ranges.
    Ai = np.asarray(entries_i)
    Aj = np.asarray(entries_j)
    Av = np.asarray(entries_v)

    obj_shift = 0.0
    # shift x = x' + l where l finite
    finite_l = np.isfinite(lower)
    if Ai.size:
        shift = lower.copy()
        shift[~finite_l] = 0.0
        # b -= A @ shift
        contrib = np.zeros(nrow)
        np.add.at(contrib, Ai, Av * shift[Aj])
        b0 = b0 - contrib
        obj_shift += float(c0 @ shift)
        upper = upper - shift
    neg_free = ~finite_l  # needs splitting x = x+ - x-

    new_cols_i: List[np.ndarray] = [Ai]
    new_cols_j: List[np.ndarray] = [Aj]
    new_cols_v: List[np.ndarray] = [Av]
    c_list = [c0]
    next_col = ncol0

    # split free variables (x = x+ - x-); remember the x- column so a
    # finite upper bound on a split variable can still be enforced below
    split_col: Dict[int, int] = {}
    for j in np.where(neg_free)[0]:
        sel = Aj == j
        new_cols_i.append(Ai[sel])
        new_cols_j.append(np.full(sel.sum(), next_col))
        new_cols_v.append(-Av[sel])
        c_list.append(np.array([-c0[j]]))
        split_col[j] = next_col
        next_col += 1

    c_extra = np.concatenate(c_list[1:]) if len(c_list) > 1 else np.zeros(0)

    # inequality rows -> slack columns.  A RANGES entry r turns row i into
    # the two-sided constraint lo <= a'x <= hi (IBM MPS standard, matching
    # the reference reader external/lp_mps.c):
    #     L:  b - |r| <= a'x <= b         a'x + s = b,      0 <= s <= |r|
    #     G:  b <= a'x <= b + |r|         a'x - s = b,      0 <= s <= |r|
    #     E, r > 0:  b <= a'x <= b + r    a'x - s = b,      0 <= s <= r
    #     E, r < 0:  b + r <= a'x <= b    a'x - s = b + r,  0 <= s <= -r
    # The slack's upper bound is enforced exactly like a variable upper
    # bound: an extra row  s + t = |r|  with fresh t >= 0.
    slack_i: List[int] = []
    slack_j: List[int] = []
    slack_v: List[float] = []
    slack_ub: List[Tuple[int, float]] = []  # (slack column, upper bound)
    for rname in row_order:
        i = row_id[rname]
        s = row_sense[rname]
        rng = ranges.get(rname)
        if s == "L":
            slack_i.append(i)
            slack_j.append(next_col)
            slack_v.append(1.0)
            if rng is not None:
                slack_ub.append((next_col, abs(rng)))
            next_col += 1
        elif s == "G":
            slack_i.append(i)
            slack_j.append(next_col)
            slack_v.append(-1.0)
            if rng is not None:
                slack_ub.append((next_col, abs(rng)))
            next_col += 1
        elif s == "E" and rng is not None and rng != 0.0:
            slack_i.append(i)
            slack_j.append(next_col)
            slack_v.append(-1.0)
            slack_ub.append((next_col, abs(rng)))
            b0[i] += min(rng, 0.0)
            next_col += 1

    ncol = next_col
    c = np.zeros(ncol)
    c[:ncol0] = c0
    if c_extra.size:
        c[ncol0 : ncol0 + c_extra.size] = c_extra

    all_i = np.concatenate(new_cols_i + [np.asarray(slack_i, dtype=np.int64)])
    all_j = np.concatenate(new_cols_j + [np.asarray(slack_j, dtype=np.int64)])
    all_v = np.concatenate(new_cols_v + [np.asarray(slack_v, dtype=np.float64)])

    # upper bounds -> extra rows.  Three sources:
    #   plain variables:  x_j + t = u_j
    #   split variables:  x_j+ - x_j- + t = u_j
    #   ranged-row slacks: s + t = |r|
    ub_rows: List[Tuple[List[Tuple[int, float]], float]] = []
    for j in np.where(np.isfinite(upper))[0]:
        if finite_l[j]:
            ub_rows.append(([(int(j), 1.0)], float(upper[j])))
        else:
            ub_rows.append(
                ([(int(j), 1.0), (split_col[int(j)], -1.0)], float(upper[j]))
            )
    for jcol, u in slack_ub:
        ub_rows.append(([(jcol, 1.0)], u))
    nrow_total = nrow + len(ub_rows)
    b_full = np.concatenate([b0, np.array([u for _, u in ub_rows])])
    ub_i: List[int] = []
    ub_j: List[int] = []
    ub_v: List[float] = []
    for k, (ents, _) in enumerate(ub_rows):
        for jcol, v in ents:
            ub_i.append(nrow + k)
            ub_j.append(jcol)
            ub_v.append(v)
        ub_i.append(nrow + k)
        ub_j.append(ncol + k)
        ub_v.append(1.0)
    if ub_rows:
        all_i = np.concatenate([all_i, np.asarray(ub_i)])
        all_j = np.concatenate([all_j, np.asarray(ub_j)])
        all_v = np.concatenate([all_v, np.asarray(ub_v)])
        c = np.concatenate([c, np.zeros(len(ub_rows))])
        ncol += len(ub_rows)

    # build CSC
    order = np.lexsort((all_i, all_j))
    all_i, all_j, all_v = all_i[order], all_j[order], all_v[order]
    col_ptr = np.zeros(ncol + 1, dtype=np.int64)
    np.add.at(col_ptr, all_j + 1, 1)
    col_ptr = np.cumsum(col_ptr)

    return MPSData(
        name=name,
        ncol=ncol,
        nrow=nrow_total,
        c=c * objsense,
        col_ptr=col_ptr,
        row_idx=all_i.astype(np.int64),
        val=all_v,
        b=b_full,
        objsense=objsense,
        obj_shift=obj_shift,
        orig_ncol=ncol0,
        orig_names=col_order,
    )


def write_mps(path: str, A: np.ndarray, b: np.ndarray, c: np.ndarray,
              name: str = "LP") -> None:
    """Write min c'x s.t. A x = b, x >= 0 as a free-format MPS file: one
    E row per row of A, one column per column, only the nonzeros, values
    in repr() so that ``read_mps`` gives back the same doubles."""
    nrow, ncol = A.shape
    out = [f"NAME          {name}", "ROWS", " N  COST"]
    out += [f" E  R{i}" for i in range(nrow)]
    out.append("COLUMNS")
    for j in range(ncol):
        if c[j] != 0.0:
            out.append(f"    X{j} COST {float(c[j])!r}")
        for i in np.flatnonzero(A[:, j]):
            out.append(f"    X{j} R{i} {float(A[i, j])!r}")
    out.append("RHS")
    out += [f"    RHS R{i} {float(b[i])!r}" for i in np.flatnonzero(b)]
    out.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
