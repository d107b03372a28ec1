"""The port's MPS reader (io/mps.py) against the JAX package's: every
field of ``MPSData`` equal, arrays bitwise with their dtypes, on MPS texts
written to ``tmp_path``."""

import dataclasses

import numpy as np
import pytest

from hdsdp_tpu.io.mps import read_mps as jread
from hdsdp_tpu_torch.io.mps import read_mps as tread

RANGED_MPS = """NAME          RANGED
ROWS
 N  COST
 L  R1
 G  R2
 E  R3
COLUMNS
    X1        COST      -1.0   R1   1.0
    X1        R2         1.0   R3   1.0
    X2        COST      -2.0   R1   1.0
    X2        R2        -1.0   R3   2.0
RHS
    RHS       R1         4.0   R2  -1.0
    RHS       R3         3.0
RANGES
    RNG       R1         2.0   R2   3.0
    RNG       R3         {r3}
ENDATA
"""

# every BOUNDS type, an OBJSENSE MAX section, a constant objective (from the
# shift of the finite lower bounds; the RHS entry on the objective row is
# read and ignored by both readers), an integer marker and a comment line
BOUNDED_MPS = """* a bounded LP
NAME          BOUNDED
OBJSENSE
    MAX
ROWS
 N  OBJ
 L  C1
 G  C2
 E  C3
COLUMNS
    MARKER                 'MARKER'                 'INTORG'
    XUP       OBJ        1.0   C1   1.0
    XUP       C2         2.0
    MARKER                 'MARKER'                 'INTEND'
    XLO       OBJ        2.0   C1   1.0
    XLO       C3         1.0
    XFX       OBJ       -1.0   C2   1.0
    XFR       OBJ        0.5   C3  -1.0
    XFR       C1         1.0
    XMI       OBJ        1.0   C2  -1.0
    XBV       OBJ        3.0   C1   2.0
    XNU       OBJ        1.5   C3   1.0
RHS
    RHS       C1        10.0   C2   1.0
    RHS       C3         2.0   OBJ  -4.0
BOUNDS
 UP BND       XUP        4.0
 LO BND       XLO       -1.0
 FX BND       XFX        2.5
 FR BND       XFR
 MI BND       XMI
 BV BND       XBV
 UP BND       XNU       -3.0
ENDATA
"""


def _assert_same(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("r3", [4.0, -4.0, 0.0])
def test_ranged_mps_matches_jax(tmp_path, r3):
    path = tmp_path / "ranged.mps"
    path.write_text(RANGED_MPS.format(r3=r3))
    _assert_same(tread(str(path)), jread(str(path)))


def test_bounds_objsense_and_shift_match_jax(tmp_path):
    path = tmp_path / "bounded.mps"
    path.write_text(BOUNDED_MPS)
    t = tread(str(path))
    _assert_same(t, jread(str(path)))
    # the text exercises what it names: maximization, a lower-bound shift
    # (XLO >= -1, XFX = 2.5), split free columns (XFR, XMI, XNU) and
    # upper-bound rows
    assert t.objsense == -1.0
    assert t.obj_shift != 0.0
    assert t.orig_ncol == 7 and t.ncol > t.orig_ncol and t.nrow > 3
