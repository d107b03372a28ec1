"""The port's native SDPA reader (native/sdpa_parser.cpp through
native/sdpa_native.py, what ``read_sdpa(path)`` runs) against its Python
parser (``read_sdpa(buffer)``) and the JAX package's ``read_sdpa``, on
files ``write_sdpa`` writes for every synthetic family; malformed files
and failed builds raise."""

import io

import numpy as np
import pytest

from hdsdp_tpu.io import sdpa as jsdpa
from hdsdp_tpu_torch.io import sdpa as tsdpa
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.native import sdpa_native
from hdsdp_tpu_torch.ops.cuda_build import BUILD_DIR

FAMILIES = {
    "gpp": ("gpp_sdpa", dict(n=20, seed=0)),
    "theta": ("theta_sdpa", dict(n=15, n_edges=30, seed=1)),
    "maxcut": ("maxcut_sdpa", dict(n=20, seed=2)),
    "torus": ("torus_sdpa", dict(side=3, seed=0)),
    "qpg": ("qpg_sdpa", dict(n=12, seed=0)),
    "control": ("control_sdpa", dict(k=4, n_sys=2, seed=3)),
    "random_lp": ("random_sdpa", dict(m=12, block_dims=[8, 6], n_lp=3, seed=4)),
}


def _assert_same(a, b):
    assert a.m == b.m and list(a.block_dims) == list(b.block_dims) and a.nnz == b.nnz
    assert a.b.dtype == b.b.dtype
    np.testing.assert_array_equal(a.b, b.b)
    assert len(a.blocks) == len(b.blocks)
    for x, y in zip(a.blocks, b.blocks):
        assert x.dim == y.dim
        for f in ("con", "row", "col", "val"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype, f
            np.testing.assert_array_equal(u, v, err_msg=f)
    assert (a.lp is None) == (b.lp is None)
    if a.lp is not None:
        assert a.lp.ncols == b.lp.ncols
        for f in ("con", "var", "val"):
            u, v = getattr(a.lp, f), getattr(b.lp, f)
            assert u.dtype == v.dtype, f
            np.testing.assert_array_equal(u, v, err_msg=f)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_native_equals_python_and_jax(family, tmp_path):
    gen, kw = FAMILIES[family]
    path = tmp_path / f"{family}.dat-s"
    tsdpa.write_sdpa(getattr(tsyn, gen)(**kw), str(path))
    with open(path, "a") as f:  # entries below 1e-12 are dropped by all three
        f.write("1 1 1 1 5e-13\n2 1 1 1 -1e-13\n")
    native = tsdpa.read_sdpa(str(path))
    with open(path) as f:
        python = tsdpa.read_sdpa(f)
    _assert_same(native, python)
    _assert_same(native, jsdpa.read_sdpa(str(path)))
    with open(path) as f:
        _assert_same(native, jsdpa.read_sdpa(f))
    if family == "random_lp":
        assert native.lp is not None


HEADER_FORMS = """* a comment
"another comment
3
2
( 2,
-2 )
{1.5, 2.5
-3.0}
0 1 1 1 1.0
1 1 1 2 2.0   # trailing comment
2 1 2 2 -1.0
3 2 1 1 4.0

3 2 2 2 0.5
BEGIN.COMMENT
anything 1 2
"""


def test_header_forms_and_trailer(tmp_path):
    path = tmp_path / "forms.dat-s"
    path.write_text(HEADER_FORMS)
    native = tsdpa.read_sdpa(str(path))
    _assert_same(native, tsdpa.read_sdpa(io.StringIO(HEADER_FORMS)))
    assert native.m == 3 and native.block_dims == [2] and native.lp.ncols == 2
    np.testing.assert_array_equal(native.b, [1.5, 2.5, -3.0])
    assert native.nnz == 5


MALFORMED = {
    "a non-number": "2\n1\n2\n1 1\n0 1 1 1 1.0\n1 1 1 x 2.0\n",
    "four columns": "2\n1\n2\n1 1\n0 1 1 1 1.0\n1 1 1 2.0\n",
    "six columns": "2\n1\n2\n1 1\n0 1 1 1 1.0 7\n",
    "a short b": "2\n1\n2\n1\n",
    "a bad m": "two\n1\n2\n1 1\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_file_raises(name, tmp_path):
    path = tmp_path / "bad.dat-s"
    path.write_text(MALFORMED[name])
    with pytest.raises(ValueError, match="line"):
        tsdpa.read_sdpa(str(path))


def test_missing_file_and_bad_blocks_raise(tmp_path):
    with pytest.raises(ValueError, match="cannot open"):
        tsdpa.read_sdpa(str(tmp_path / "absent.dat-s"))
    path = tmp_path / "lp_first.dat-s"
    path.write_text("1\n2\n-2 3\n1.0\n1 2 1 1 1.0\n")
    with pytest.raises(ValueError, match="last block"):
        tsdpa.read_sdpa(str(path))


def test_builds_into_the_build_directory():
    lib = sdpa_native.build()
    assert lib.parent == BUILD_DIR and BUILD_DIR.name == "hdsdp_tpu_torch"
    assert lib.name.startswith("libsdpa_parser-") and lib.exists()


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "sdpa_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(sdpa_native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        sdpa_native.build()
