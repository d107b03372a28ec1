"""KKT cross-validation diagnostic (ref HUtilKKTCheck,
interface/hdsdp_utils.c:536-707).

The reference builds the Schur matrix three ways (forced M3, forced M4,
hybrid) and compares elementwise to 1e-8 relative: its strongest
correctness oracle.  Here the two independent assemblies are the port's
bucketed KKT build (``ConeSystem.build_kkt``, the production path on the
device) and a naive dense reconstruction M_ij = <A_i, S^-1 A_j S^-1> in
numpy from the raw per-block coefficient stacks.  Usable as a runtime
diagnostic on any problem small enough to densify (m * n^2 doubles per
block).
"""

from __future__ import annotations

import numpy as np


def _dense_stack(info_list, n: int, m: int) -> np.ndarray:
    """[m+1, n, n] dense coefficients (index 0 = C) from CoeffInfo."""
    out = np.zeros((m + 1, n, n))
    for i, info in enumerate(info_list):
        if info.rank == 0:
            continue
        if info.dense is not None:
            out[i] = info.dense
        else:
            out[i] = (info.vecs.T * info.lam) @ info.vecs
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def kkt_cross_validate(prob, y=None, Rd: float = -1.0, rtol: float = 1e-08,
                       device="cuda"):
    """Compare the bucketed KKT build on ``device`` against a naive dense
    reference on the host.

    Returns a dict of max relative errors; raises AssertionError if any
    exceeds `rtol` (matching the reference's 1e-8 gate)."""
    import torch

    from hdsdp_tpu_torch.solver.cones import ConeSystem
    from hdsdp_tpu_torch.utils.device import DTYPE, resolve_device

    dev = resolve_device(device)
    m = prob.m
    rng_y = np.zeros(m) if y is None else np.asarray(y)
    cones = ConeSystem(prob, dev)
    shift = 10.0 - Rd + prob.features.obj_fro_norm

    S, s_lp = cones.assemble(1.0, -1.0, torch.as_tensor(rng_y, dtype=DTYPE, device=dev),
                             shift)
    ok, L = cones.factor(S, s_lp)
    if not bool(ok):
        raise ValueError("reference point is not interior; adjust y/shift")
    kkt = cones.build_kkt(L, s_lp, Rd, "inf")

    M_ref = np.zeros((m, m))
    asinv_ref = np.zeros(m)
    rd_ref = np.zeros(m)
    for gi, grp in enumerate(prob.groups):
        n = grp.dim
        for slot, ib in enumerate(grp.block_ids):
            A_all = _dense_stack(prob.block_infos[ib], n, m)
            U = np.linalg.inv(_host(S[gi][slot]))
            A = A_all[1:]
            B = np.einsum("pq,iqr,rs->ips", U, A, U)
            M_ref += np.einsum("ipq,jpq->ij", B, A)
            asinv_ref += np.einsum("ipq,pq->i", A, U)
            rd_ref += Rd * np.trace(B, axis1=1, axis2=2)
    if prob.lp is not None:
        si = 1.0 / _host(s_lp)
        Alp = prob.lp.A
        M_ref += (Alp * (si * si)[None, :]) @ Alp.T
        asinv_ref += Alp @ si
        rd_ref += Rd * (Alp @ (si * si))

    scale = max(1.0, float(np.abs(M_ref).max()))
    errs = {
        "M": float(np.abs(_host(kkt.M) - M_ref).max()) / scale,
        "asinv": float(np.abs(_host(kkt.asinv) - asinv_ref).max())
        / max(1.0, float(np.abs(asinv_ref).max())),
        "asinvrdsinv": float(np.abs(_host(kkt.asinvrdsinv) - rd_ref).max())
        / max(1.0, float(np.abs(rd_ref).max())),
    }
    for k, v in errs.items():
        if v > rtol:
            raise AssertionError(f"KKT cross-validation failed: {k} err {v:.2e}")
    return errs
