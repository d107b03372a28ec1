"""The maxG55 configuration: SDPLIB's published sizes, and its generator's
instances, cut to n = 60 at G55's average degree, solved through the solo
entry on the host and held to the plain reference in float64."""

import tempfile

import numpy as np
import pytest

from sdpbench import catalog, check, reference, tracing, traffic


def test_published_sizes():
    cfg = catalog.config("maxG55")
    pub = cfg["published"]
    assert (pub["n"], pub["m"], pub["blocks"], pub["edges"]) == (5000, 5000, [5000], 12498)
    assert cfg["args"] == {"n": 5000, "n_edges": 12498, "weights": "unit", "diag": 1.0}
    assert pub["weights"] == "unit" and pub["diag"] == 1.0
    assert cfg["generator"] == "maxcut" and cfg["reduced"] == [] and cfg["solver"] == {}
    assert cfg["guarantees"]["status"] == check.OPTIMAL


@pytest.mark.parametrize("seed, k", [(2 ** 31 + 11, 0), (7, 1), (4294967311, 2)])
def test_a_cut_instance_matches_the_reference(seed, k):
    """Instance k of a pool of 3 (three graphs), relabelled by the seed."""
    cfg = catalog.config("maxG55")
    # n cut to 60; 150 edges keep G55's average degree, 2 x 12498 / 5000 = 5.0
    args = dict(cfg["args"], n=60, n_edges=150)
    gen = catalog.generator(cfg["generator"])
    mix = {"pool": 3, "fleet": 1, "sample": 1, "draw": "relabel"}
    with tempfile.TemporaryDirectory() as tmp:
        pool = traffic.make_pool(gen, args, seed, mix["pool"], tmp, mix["draw"])
        assert pool.data[k].m == 60 and pool.data[k].blocks[0].dim == 60
        call = traffic.solve_call(k, pool, mix, dict(cfg["solver"], verbose=False), "cpu",
                                  tracing.Tracer(lambda: None, enabled=False))
    ans = call.answers[0]
    assert ans.instance == k and ans.status == check.OPTIMAL and ans.X is not None
    prob = reference.Problem(pool.data[k])
    sol = reference.solve(prob)
    assert sol.status == "optimal"
    opt = 0.5 * (sol.p_obj + sol.d_obj)
    # the program stops at a 1e-8 scaled gap, the reference at 1e-10: the
    # objectives agree to the program's tolerance, with 10x room for the
    # scaling of its internal gap
    for v in (ans.p_obj, ans.d_obj):
        assert abs(v - opt) / (1.0 + abs(opt)) < 1e-7
    cert = reference.certificate(prob, ans.y, ans.X)
    # the DIMACS errors recomputed from the data: the program's 1e-8
    # feasibility and gap tolerances, with the same 10x room
    assert max(cert.p_infeas, cert.x_neg, cert.s_neg, cert.gap) < 1e-7
    assert abs(cert.d_obj - ans.d_obj) <= 1e-9 * (1.0 + abs(ans.d_obj))
    assert np.isclose(cert.p_obj, ans.p_obj, rtol=1e-7, atol=0.0)
