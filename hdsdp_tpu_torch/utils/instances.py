"""The named instances that the card-side scripts solve (``chip_smoke.py``
at the repository root and ``utils.stage_profile``): synthetic problems at
the sizes SDPLIB publishes for their family, nothing cut, and one theta
instance above the operator-mode threshold.

    name: (generator in models.synthetic, its arguments, solver overrides)
"""

from __future__ import annotations

import numpy as np

from hdsdp_tpu_torch.io.mps import write_mps
from hdsdp_tpu_torch.io.sdpa import write_sdpa
from hdsdp_tpu_torch.models import synthetic

INSTANCES = {
    # m = 501, one 500^2 block: slot-major bucket + a dense row, Ozaki assembly
    "gpp500": ("gpp_sdpa", dict(n=500, seed=0), dict(kkt_hp="on")),
    # m = 1000, one 1000^2 block: diag bucket, identity map
    "maxG51": ("maxcut_sdpa", dict(n=1000, seed=0), {}),
    # m = 3375, one 3375^2 block: diag bucket at the largest direct-factor size
    "torusg3-15": ("torus_sdpa", dict(side=15, pm=False, seed=0), {}),
    # m = 4375, one 300^2 block: support bucket + dense identity row,
    # AdaptiveCG (m >= 4096) and PSDP (300 < 4375 / 3)
    "theta6": ("theta_sdpa", dict(n=300, n_edges=4374, seed=0), {}),
    # m = 5000, one 5000^2 block: diag bucket + AdaptiveCG
    "maxG55": ("maxcut_sdpa", dict(n=5000, seed=0), {}),
    # m = 1540, three 55^2 blocks: flat bucket, g = 3
    "control11": ("control_sdpa", dict(k=55, n_sys=2, seed=0), {}),
    # m = 25001, one 700^2 block: above kkt_free_threshold, so the default
    # path runs matrix-free (support bucket, f32 chunked preconditioner,
    # PSDP's operator branch, the matrix-free check re-solve)
    "theta-m25001": ("theta_sdpa", dict(n=700, n_edges=25000, seed=0), {}),
    # m = 1000, one 300^2 block: generic slot-major bucket with about 500
    # dense coefficients, strictly feasible, PSDP (300 < 1000 / 3).  The
    # generic-bucket instance for kkt_mode="free": CG cannot carry the gpp
    # family (its Schur system walks the whole ladder to the direct factor
    # at every iteration, in the JAX package too)
    "random-m1000": ("random_sdpa", dict(m=1000, block_dims=[300], seed=0), {}),
}


def write_instance(name: str, path: str) -> dict:
    """Write the named instance to ``path`` in SDPA format; returns the
    solver overrides to pass to ``solve_sdpa_file``."""
    gen, kw, overrides = INSTANCES[name]
    write_sdpa(getattr(synthetic, gen)(**kw), path)
    return dict(overrides)


# LP instances for solve_mps_file: name -> (nrow, ncol, density, seed).
# lp1800: the row count of 10teams as the JAX package reads it (nrow =
# 1800, tests/test_lp.py) at 4500 columns and 1 % density
LP_INSTANCES = {
    "lp1800": (1800, 4500, 0.01, 0),
}


def random_lp(nrow: int, ncol: int, density: float, seed: int):
    """(A, b, c) of a sparse, strictly primal and dual feasible LP in
    standard form, in the pattern of the JAX package's random LP test:
    b = A x0 with x0 > 0, c = A' y0 + s0 with s0 > 0."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((nrow, ncol)) < density, rng.normal(size=(nrow, ncol)), 0.0)
    x0 = rng.random(ncol) + 0.5
    b = A @ x0
    c = A.T @ rng.normal(size=nrow) + rng.random(ncol) + 0.5
    return A, b, c


def write_lp_instance(name: str, path: str) -> None:
    """Write the named LP instance to ``path`` in MPS format."""
    A, b, c = random_lp(*LP_INSTANCES[name])
    write_mps(path, A, b, c, name=name)
