"""The arithmetic of the S^-1 readers, sinv_roofline and sinv_per_iter, on
hand-made spans and kernel intervals."""

import pytest

from sdpbench import catalog, roofline, tracing
from sdpbench.record import Record
from sdpbench.traffic import Call

H100 = "NVIDIA H100 80GB HBM3"


def _record(profile, spans, kind=H100, iterations=(10, 10)):
    return Record("w", {}, {}, 1.0, 2.0, [Call([], i) for i in iterations], 1, kind,
                  roofline.peaks(kind), spans, profile)


def _profile(calls, k_ns):
    """One ``sinv`` span per call, each holding two kernels of ``k_ns`` ns,
    and a kernel outside every span."""
    kernels, spans = [("outside", 1, 2)], []
    for c in range(calls):
        t = 1e9 * (c + 1)
        kernels += [("trsm", t, t + k_ns), ("gemm", t + k_ns, t + 2 * k_ns)]
        spans.append(("sinv", t - 5, t + 2 * k_ns + 5))
    return tracing.Profile(ops=list(kernels), kernels=kernels, spans=spans)


def test_sinv_counts():
    rd = catalog.metric("sinv_roofline")
    # potri's work: the triangular inverse and L^-T L^-1, n^3 / 3 each
    assert rd.sinv_flops(3000) == pytest.approx(2 * 3000 ** 3 / 3)
    assert rd.sinv_flops(10, batch=8) == pytest.approx(8 * 2000 / 3)
    assert rd.sinv_bytes(5000) == 16 * 5000 ** 2 == 4e8
    assert rd.sinv_bytes(10, batch=3) == 3 * 1600
    # n = 5000 on an H100: bound by operations, 1.24 ms a matrix
    p = roofline.peaks(H100)
    t = roofline.least_time(rd.sinv_flops(5000), rd.sinv_bytes(5000), p["fp64_tensor_flops"],
                            p["hbm_bytes_per_s"])
    assert t == pytest.approx(2 * 5000 ** 3 / 3 / 67e12)


@pytest.mark.parametrize("n", [5000, 64], ids=["operations", "bytes"])
def test_sinv_roofline_reader(n):
    rd = catalog.metric("sinv_roofline")
    p = roofline.peaks(H100)
    least = roofline.least_time(rd.sinv_flops(n), rd.sinv_bytes(n), p["fp64_tensor_flops"],
                                p["hbm_bytes_per_s"])
    spans = [tracing.Span("sinv", 0, 1, ((1, n, n),)), tracing.Span("sinv", 2, 3, ((1, n, n),))]
    # each call's two kernels take least / 0.2 in all: a share of 20 %
    assert rd.read(_record(_profile(2, least / 0.2 / 2 * 1e9), spans)) == pytest.approx(20.0)
    # kernel time equal to the least time: 100 %, never more
    share = rd.read(_record(_profile(2, least / 2 * 1e9), spans))
    assert share == pytest.approx(100.0) and share <= 100.0 + 1e-9
    # the batch axis: a fleet of 4 (one block each) counts four matrices
    fleet = [tracing.Span("sinv", 0, 1, ((4, 1, n, n),))] * 2
    assert rd.read(_record(_profile(2, least / 0.2 / 2 * 1e9), fleet)) == pytest.approx(80.0)


def test_sinv_roofline_nothing_to_read():
    rd = catalog.metric("sinv_roofline")
    spans = [tracing.Span("sinv", 0, 1, ((1, 100, 100),))]
    prof = _profile(1, 1000)
    assert rd.read(_record(prof, [])) is None  # no S^-1 ran
    assert rd.read(_record(None, spans)) is None  # no trace
    assert rd.read(_record(prof, spans, kind="cpu")) is None  # no published peaks
    # spans but no kernel inside them
    assert rd.read(_record(tracing.Profile(kernels=[("k", 1, 2)]), spans)) is None


def test_sinv_per_iter_reader():
    rd = catalog.metric("sinv_per_iter")
    spans = [tracing.Span("sinv", i, i + 1, ((1, 8, 8),)) for i in range(41)]
    spans.append(tracing.Span("factor_m", 0, 1, ((8, 8),)))
    assert rd.read(_record(None, spans)) == pytest.approx(41 / 20)
    assert rd.read(_record(None, [])) is None
    assert rd.read(_record(None, spans, iterations=())) is None
    assert rd.SPANS == catalog.metric("sinv_roofline").SPANS
