"""Problem intermediate representation: bucketed, batched cone data.

Converts raw SDPA data into the batched device layout:

  * SDP blocks are grouped by dimension; each group is a batch [g, n, n].
  * Constraint coefficients live in two buckets per group
    (see hdsdp_tpu_torch.models.coeffs):
      - low-rank factors  F:[g, R, n], lam:[g, R], seg:[g, R]
      - dense matrices    Ad:[md, n, n] with (didx, dblk)
  * The LP block (negative SDPA dimension) becomes a dense [m, nlp] matrix.

Parity notes:
  * the cone-type choice dense vs sparse SDP at 30% row-nnz
    (ref hdsdp_user_data.c:73-98) is irrelevant here: the bucket layout
    handles both uniformly;
  * feature detection mirrors sdpDenseConeFeatureDetectImpl
    (ref hdsdp_conic_sdp.c:2651-2745).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from hdsdp_tpu_torch.io.sdpa import SDPAData
from hdsdp_tpu_torch.models.coeffs import (
    COEFF_DENSE,
    COEFF_DSR1,
    COEFF_SPARSE,
    COEFF_SPR1,
    COEFF_ZERO,
    CoeffInfo,
    analyze_block,
)
from hdsdp_tpu_torch.utils import profile


@dataclass
class ConeGroupData:
    """A batch of same-dimension SDP blocks (host-side numpy)."""

    dim: int
    nblk: int
    block_ids: List[int]  # original block indices
    C: np.ndarray  # [g, n, n]
    # low-rank bucket, padded to R per block (lam = 0 padding)
    F: np.ndarray  # [g, R, n]
    lam: np.ndarray  # [g, R]
    seg: np.ndarray  # [g, R] int32 constraint index (0 for padding)
    # dense bucket
    Ad: np.ndarray  # [md, n, n]
    didx: np.ndarray  # [md] int32 constraint index
    dblk: np.ndarray  # [md] int32 block index within group

    @property
    def R(self) -> int:
        return self.F.shape[1]

    @property
    def md(self) -> int:
        return self.Ad.shape[0]


@dataclass
class LPConeData:
    """LP cone: dual s = -Rd - A'y + tau*c (ref interface/hdsdp_conic_lp.c)."""

    nlp: int
    A: np.ndarray  # [m, nlp] dense rows
    c: np.ndarray  # [nlp]
    abs_norm_obj: float = 0.0
    fro_norm_obj: float = 0.0
    abs_norm_data: float = 0.0
    fro_norm_data: float = 0.0


@dataclass
class Features:
    """Model features driving parameter auto-tuning (ref def_hdsdp.h:25-57)."""

    n_rows: int = 0
    n_cones: int = 0
    n_sum_cone_dims: int = 0
    n_max_cone_dim: int = 0
    n_zero_mats: int = 0
    n_sp_mats: int = 0
    n_ds_mats: int = 0
    n_spr1_mats: int = 0
    n_dsr1_mats: int = 0
    many_cones: bool = False
    null_obj: bool = False
    no_primal_interior: bool = False
    no_dual_interior: bool = False
    implied_trace: bool = False
    implied_trace_x: float = 0.0
    very_dense: bool = False
    imp_y_up: float = 0.0
    imp_y_low: float = 0.0
    imp_y_bound: bool = False
    obj_fro_norm: float = 0.0
    obj_one_norm: float = 0.0
    data_fro_norm: float = 0.0
    data_one_norm: float = 0.0
    rhs_one_norm: float = 0.0
    rhs_fro_norm: float = 0.0
    rhs_inf_norm: float = 0.0
    obj_scaling: float = 1.0
    rhs_scaling: float = 1.0
    n_lp_cols: int = 0


@dataclass
class SDPProblem:
    m: int
    b: np.ndarray  # [m] (possibly scaled in-place by the solver)
    groups: List[ConeGroupData] = field(default_factory=list)
    lp: Optional[LPConeData] = None
    features: Features = field(default_factory=Features)
    # per-block coefficient analysis kept for tests / refinement
    block_infos: List[List[CoeffInfo]] = field(default_factory=list)
    block_dims: List[int] = field(default_factory=list)

    # ------------------------------------------------------------------
    @staticmethod
    def from_sdpa(data: SDPAData, rank_cap: int = 8, max_eig_support: int = 2048) -> "SDPProblem":
        with profile.span("presolve"):
            m = data.m
            prob = SDPProblem(m=m, b=np.asarray(data.b, dtype=np.float64).copy())
            prob.block_dims = list(data.block_dims)

            all_infos: List[List[CoeffInfo]] = []
            for blk in data.blocks:
                with profile.span("analyze"):
                    infos = analyze_block(
                        blk.dim, m, blk.con, blk.row, blk.col, blk.val, rank_cap,
                        max_eig_support
                    )
                all_infos.append(infos)
            prob.block_infos = all_infos

            # group blocks by dim
            by_dim: Dict[int, List[int]] = {}
            for ib, d in enumerate(data.block_dims):
                by_dim.setdefault(d, []).append(ib)

            for dim, block_ids in sorted(by_dim.items()):
                prob.groups.append(_build_group(dim, block_ids, all_infos, m))

            if data.lp is not None:
                prob.lp = _build_lp(data, m)

            prob.features = _collect_features(prob)
            return prob

    # ------------------------------------------------------------------
    @staticmethod
    def from_dense_blocks(
        C_blocks: List[np.ndarray],
        A_blocks: List[np.ndarray],
        b: np.ndarray,
        lp_A: Optional[np.ndarray] = None,
        lp_c: Optional[np.ndarray] = None,
        **kwargs,
    ) -> "SDPProblem":
        """Programmatic construction (ref HUserDataSetConeData /
        HUserDataChooseCone, interface/hdsdp_user_data.c): one [n, n]
        objective matrix and one [m, n, n] coefficient stack per SDP
        block, plus an optional LP block (lp_A [m, nlp], lp_c [nlp])."""
        from hdsdp_tpu_torch.io.sdpa import BlockEntries, LPEntries, SDPAData

        m = len(b)
        data = SDPAData(
            m=m,
            block_dims=[C.shape[0] for C in C_blocks],
            b=np.asarray(b, np.float64),
        )
        for C, A in zip(C_blocks, A_blocks):
            n = C.shape[0]
            if A.shape != (m, n, n):
                raise ValueError(f"A stack must be [m, n, n], got {A.shape}")
            il, jl = np.tril_indices(n)
            cons, rows, cols, vals = [], [], [], []
            for i, Mat in enumerate([C] + list(A)):
                v = np.asarray(Mat)[il, jl]
                keep = v != 0.0
                cons.append(np.full(int(keep.sum()), i, np.int32))
                rows.append(il[keep].astype(np.int32))
                cols.append(jl[keep].astype(np.int32))
                vals.append(v[keep])
            data.blocks.append(
                BlockEntries(
                    dim=n,
                    con=np.concatenate(cons),
                    row=np.concatenate(rows),
                    col=np.concatenate(cols),
                    val=np.concatenate(vals),
                )
            )
        if lp_A is not None:
            nlp = lp_A.shape[1]
            con_l = [np.zeros(nlp, np.int32)]
            var_l = [np.arange(nlp, dtype=np.int32)]
            val_l = [np.asarray(lp_c, np.float64)]
            for i in range(m):
                con_l.append(np.full(nlp, i + 1, np.int32))
                var_l.append(np.arange(nlp, dtype=np.int32))
                val_l.append(np.asarray(lp_A[i], np.float64))
            data.lp = LPEntries(
                ncols=nlp,
                con=np.concatenate(con_l),
                var=np.concatenate(var_l),
                val=np.concatenate(val_l),
            )
        return SDPProblem.from_sdpa(data, **kwargs)

    # convenience
    @property
    def sum_cone_dims(self) -> int:
        s = sum(self.block_dims)
        if self.lp is not None:
            s += self.lp.nlp
        return s


def _dense_of(info: CoeffInfo, n: int) -> np.ndarray:
    if info.dense is not None:
        return info.dense
    if info.rank == 0:
        return np.zeros((n, n))
    return (info.vecs.T * info.lam) @ info.vecs


def _build_group(
    dim: int, block_ids: List[int], all_infos: List[List[CoeffInfo]], m: int
) -> ConeGroupData:
    g = len(block_ids)
    C = np.zeros((g, dim, dim))
    lr_rows: List[List] = [[] for _ in range(g)]  # (lam, vec, con)
    dense_list = []
    didx_list: List[int] = []
    dblk_list: List[int] = []

    for k, ib in enumerate(block_ids):
        infos = all_infos[ib]
        C[k] = _dense_of(infos[0], dim)
        for i in range(1, m + 1):
            info = infos[i]
            if info.rank == 0:
                continue
            if info.lam is not None:
                for r in range(info.rank):
                    lr_rows[k].append((info.lam[r], info.vecs[r], i - 1))
            else:
                dense_list.append(info.dense)
                didx_list.append(i - 1)
                dblk_list.append(k)

    R = max((len(rows) for rows in lr_rows), default=0)
    R = max(R, 1)
    F = np.zeros((g, R, dim))
    lam = np.zeros((g, R))
    seg = np.zeros((g, R), dtype=np.int32)
    for k, rows in enumerate(lr_rows):
        for r, (lv, vec, con) in enumerate(rows):
            lam[k, r] = lv
            F[k, r] = vec
            seg[k, r] = con

    Ad = (
        np.stack(dense_list, axis=0)
        if dense_list
        else np.zeros((0, dim, dim))
    )
    return ConeGroupData(
        dim=dim,
        nblk=g,
        block_ids=block_ids,
        C=C,
        F=F,
        lam=lam,
        seg=seg,
        Ad=Ad,
        didx=np.asarray(didx_list, dtype=np.int32),
        dblk=np.asarray(dblk_list, dtype=np.int32),
    )


def _build_lp(data: SDPAData, m: int) -> LPConeData:
    lp = data.lp
    A = np.zeros((m, lp.ncols))
    c = np.zeros(lp.ncols)
    is_obj = lp.con == 0
    np.add.at(c, lp.var[is_obj], lp.val[is_obj])
    np.add.at(A, (lp.con[~is_obj] - 1, lp.var[~is_obj]), lp.val[~is_obj])
    return LPConeData(
        nlp=lp.ncols,
        A=A,
        c=c,
        abs_norm_obj=float(np.abs(c).sum()),
        fro_norm_obj=float(np.linalg.norm(c)),
        abs_norm_data=float(np.abs(A).sum()),
        fro_norm_data=float(np.linalg.norm(A)),
    )


def _collect_features(prob: SDPProblem) -> Features:
    """Statistics + structure detection (ref hdsdp.c:33-116, 136-278)."""

    f = Features()
    f.n_rows = prob.m
    n_sdp_cones = len(prob.block_dims)
    f.n_cones = n_sdp_cones + (1 if prob.lp is not None else 0)
    f.n_sum_cone_dims = prob.sum_cone_dims
    f.n_max_cone_dim = max(prob.block_dims) if prob.block_dims else 0
    f.n_lp_cols = prob.lp.nlp if prob.lp is not None else 0

    obj_one = obj_fro2 = data_one = data_fro2 = 0.0
    for infos in prob.block_infos:
        obj_one += infos[0].abs_norm
        obj_fro2 += infos[0].fro_norm ** 2
        for info in infos[1:]:
            data_one += info.abs_norm
            data_fro2 += info.fro_norm ** 2
            if info.ref_type == COEFF_ZERO:
                f.n_zero_mats += 1
            elif info.ref_type == COEFF_SPARSE:
                f.n_sp_mats += 1
            elif info.ref_type == COEFF_DENSE:
                f.n_ds_mats += 1
            elif info.ref_type == COEFF_SPR1:
                f.n_spr1_mats += 1
            elif info.ref_type == COEFF_DSR1:
                f.n_dsr1_mats += 1
    if prob.lp is not None:
        obj_one += prob.lp.abs_norm_obj
        obj_fro2 += prob.lp.fro_norm_obj ** 2
        data_one += prob.lp.abs_norm_data
        data_fro2 += prob.lp.fro_norm_data ** 2

    f.obj_one_norm = obj_one
    f.obj_fro_norm = float(np.sqrt(obj_fro2))
    f.data_one_norm = data_one
    f.data_fro_norm = float(np.sqrt(data_fro2))
    f.rhs_one_norm = float(np.abs(prob.b).sum())
    f.rhs_fro_norm = float(np.linalg.norm(prob.b))
    f.rhs_inf_norm = float(np.abs(prob.b).max()) if prob.m else 0.0
    f.null_obj = f.obj_fro_norm == 0.0
    f.many_cones = f.n_cones >= 100

    # Single-cone structure detection (ref hdsdp.c:162-169,
    # hdsdp_conic_sdp.c:2651-2745)
    if n_sdp_cones == 1:
        infos = prob.block_infos[0]
        dim = prob.block_dims[0]
        ndense = 0
        unit_cols = {}
        imp_trace = 0.0
        imp_trace_hit = False
        for i, info in enumerate(infos[1:]):
            if info.ref_type == COEFF_DENSE:
                ndense += 1
            if info.rank == 1 and abs(prob.b[i]) < 1e-03 * info.fro_norm:
                f.no_primal_interior = True
            if not imp_trace_hit and info.is_eye_multiple:
                ratio = prob.b[i] / info.is_eye_multiple
                if ratio > 0.0:
                    imp_trace_hit = True
                    imp_trace = ratio
            if info.unit_col is not None and info.unit_col not in unit_cols:
                unit_cols[info.unit_col] = prob.b[i]
        if not imp_trace_hit and len(unit_cols) == dim:
            imp_trace_hit = True
            imp_trace = float(sum(unit_cols.values()))
        if imp_trace_hit:
            f.implied_trace = True
            f.implied_trace_x = imp_trace
        if ndense >= 0.7 * prob.m:
            f.very_dense = True

    if prob.lp is not None:
        _detect_lp_features(prob.lp, f)

    return f


def _detect_lp_features(lp: LPConeData, f: Features) -> None:
    """LP structure detectors (ref hdsdp_conic_lp.c:540-667).

    1. Implied dual box l <= y <= u: every LP row of A touches at most
       two columns, one with a positive and one with a negative entry;
       a positive a_ij bounds y_i <= c_j / a_ij, a negative one bounds
       y_i >= c_j / a_ij.
    2. No dual interior: columns pair up as (x+, x-) splits — objective
       and every row's entries cancel pairwise — so s = c - A'y comes in
       +/- pairs and no strictly positive dual slack exists.
    """
    nlp, m = lp.nlp, lp.A.shape[0]
    if nlp % 2 != 0 or nlp < 100:
        return

    up_tmp = np.zeros(m)
    low_tmp = np.zeros(m)
    implied = True
    has_up = has_low = False
    for i in range(m):
        row = lp.A[i]
        nz = np.flatnonzero(row)
        if nz.size > 2:
            implied = False
            break
        for j in nz:
            bound = lp.c[j] / row[j]
            if row[j] > 0.0:
                if up_tmp[i]:
                    implied = False
                    break
                has_up = True
                up_tmp[i] = max(up_tmp[i], bound)
            else:
                if low_tmp[i]:
                    implied = False
                    break
                has_low = True
                low_tmp[i] = min(low_tmp[i], bound)
        if not implied:
            break

    if implied:
        f.imp_y_bound = True
        if has_up:
            up = max(1.0, float(up_tmp.max()) if m else 1.0)
            f.imp_y_up = up if up > 0.0 else 1.0
        if has_low:
            low = min(-1.0, float(low_tmp.min()) if m else -1.0)
            f.imp_y_low = low if low < 0.0 else -1.0

    half = nlp // 2
    if np.any(lp.c[:half] + lp.c[half:] != 0.0):
        return
    for i in range(m):
        vals = lp.A[i][np.flatnonzero(lp.A[i])]
        hn, rem = divmod(vals.size, 2)
        if rem or np.any(vals[:hn] + vals[hn:] != 0.0):
            return
    f.no_dual_interior = True
