"""The frozen generators give the port's generators' arrays bit for bit at
the arguments the port's instances use (this test alone reads the port:
the benchmark's generators and reference never import it)."""

import numpy as np
import pytest

from hdsdp_tpu_torch.models import synthetic
from sdpbench.generators import maxcut, theta


def _same(ours, theirs):
    assert ours.m == theirs.m
    assert np.array_equal(ours.b, theirs.b) and ours.b.dtype == theirs.b.dtype
    assert [b.dim for b in ours.blocks] == list(theirs.block_dims)
    for a, b in zip(ours.blocks, theirs.blocks):
        for k in ("con", "row", "col", "val"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("kw", [dict(n=1000, seed=0), dict(n=5000, seed=0), dict(n=100, seed=3),
                                dict(n=60, seed=1, degree=4)])
def test_maxcut_is_the_ports(kw):
    seed = kw.pop("seed")
    _same(maxcut.generate(seed, **kw), synthetic.maxcut_sdpa(seed=seed, **kw))


@pytest.mark.parametrize("kw", [dict(n=300, n_edges=4374, seed=0), dict(n=64, n_edges=511, seed=3),
                                dict(n=30, n_edges=120, seed=1)])
def test_theta_is_the_ports(kw):
    seed = kw.pop("seed")
    _same(theta.generate(seed, **kw), synthetic.theta_sdpa(seed=seed, **kw))


def test_maxcut_g51_shape():
    d = maxcut.generate(np.random.SeedSequence([5, 0]), n=1000, n_edges=5909, weights="unit",
                        diag=1.0)
    blk = d.blocks[0]
    edges = (blk.con == 0) & (blk.row != blk.col)
    assert d.m == 1000 and edges.sum() == 5909 and np.all(blk.val[edges] == 0.25)
    assert np.all(d.b == 1.0) and np.all(blk.val[blk.con > 0] == 1.0)
    assert np.all(blk.row >= blk.col)
