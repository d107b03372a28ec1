"""The interval and roofline arithmetic of the device metrics."""

import math

import pytest

from sdpbench import catalog, roofline, tracing
from sdpbench.record import Record
from sdpbench.traffic import Call


def test_union_length():
    assert tracing.union_length([]) == 0.0
    assert tracing.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert tracing.union_length([(5, 6), (0, 10)]) == 10


def test_idle_gaps():
    assert tracing.idle_gaps([(2, 3), (5, 7)], 0, 10) == [(0, 2), (3, 5), (7, 10)]
    assert tracing.idle_gaps([(0, 4), (3, 10)], 0, 10) == []
    assert tracing.idle_gaps([], 1, 2) == [(1, 2)]


def test_innermost():
    spans = [("outer", 0, 10), ("inner", 2, 4), ("later", 6, 8)]
    assert tracing.innermost(spans, [1, 3, 5, 7, 9, 11]) == ["outer", "inner", "outer", "later",
                                                             "outer", None]


def test_cholesky_counts():
    assert roofline.cholesky_flops(1000) == pytest.approx(1e9 / 3)
    assert roofline.cholesky_flops(10, batch=8) == pytest.approx(8 * 1000 / 3)
    assert roofline.cholesky_bytes(1000) == 16e6
    assert roofline.schur_assembly_flops(m=10, n=4, r=2) == 2 * 2 * 10 * 16 + 3 * 2 * 100 * 4
    # m = 4375 on an H100: the flops bound (0.42 ms) is above the bytes bound
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    t = roofline.least_time(roofline.cholesky_flops(4375), roofline.cholesky_bytes(4375),
                            p["fp64_tensor_flops"], p["hbm_bytes_per_s"])
    assert t == pytest.approx(4375 ** 3 / 3 / 67e12)
    assert roofline.peaks("no such card") is None


def _record(profile, spans, kind="NVIDIA H100 80GB HBM3"):
    return Record("w", {}, {}, 1.0, 2.0, [Call([], 10), Call([], 10)], 1, kind,
                  roofline.peaks(kind), spans, profile)


def test_mfactor_roofline_reader():
    m = 2000
    least = roofline.cholesky_flops(m) / 67e12
    # two factor_m calls, each with two kernels of least / 0.25 / 2 seconds
    k = least / 0.25 / 2 * 1e9
    prof = tracing.Profile(
        ops=[], kernels=[("potrf", 100, 100 + k), ("check", 100 + k, 100 + 2 * k),
                         ("other", 5e9, 6e9),
                         ("potrf", 1e10, 1e10 + k), ("check", 1e10 + k, 1e10 + 2 * k)],
        spans=[("factor_m", 50, 100 + 2 * k + 10), ("factor_m", 1e10 - 5, 1e10 + 2 * k + 5)])
    spans = [tracing.Span("factor_m", 0, 1, ((m, m),)), tracing.Span("factor_m", 2, 3, ((m, m),))]
    rd = catalog.metric("mfactor_roofline")
    assert rd.read(_record(prof, spans)) == pytest.approx(25.0)
    # a fleet's M: the bound counts every instance
    spans8 = [tracing.Span("factor_m", 0, 1, ((8, m, m),)), tracing.Span("factor_m", 2, 3, ((8, m, m),))]
    assert rd.read(_record(prof, spans8)) == pytest.approx(200.0)
    # nothing to read: no trace, or a card without published peaks
    assert rd.read(_record(None, spans)) is None
    assert rd.read(_record(prof, spans, kind="cpu")) is None


def test_device_idle_and_launches():
    prof = tracing.Profile(ops=[("k", 10, 20), ("Memcpy DtoH", 30, 40), ("k", 35, 50)],
                           kernels=[("k", 10, 20), ("k", 35, 50)],
                           spans=[("window", 0, 100)])
    rec = _record(prof, [])
    assert rec.busy_s() == pytest.approx(30e-9)
    assert catalog.metric("device_idle").read(rec) == pytest.approx(70.0)
    assert catalog.metric("launches_per_iter").read(rec) == pytest.approx(2 / 20)
    assert catalog.metric("iters_per_solve").read(rec) == 10
    assert math.isclose(catalog.metric("iter_ms").read(rec), 1e3 * 2.0 / 20)
