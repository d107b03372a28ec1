"""Top-level solver API (ref interface/hdsdp.h:108-120: HDSDPCreate /
SetCone / SetDualObjective / Optimize / GetRowDual / CheckSolution)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from hdsdp_tpu_torch.io.sdpa import read_sdpa
from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.solver import algo, dimacs
from hdsdp_tpu_torch.solver.params import Params
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.checkpoint import (
    apply_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from hdsdp_tpu_torch.utils.device import resolve_device


@dataclass
class Result:
    status: str
    p_obj: float
    d_obj: float
    gap: float
    y: np.ndarray
    dimacs: np.ndarray
    n_iters: int
    solve_time: float
    stats: dict = field(default_factory=dict)
    device: str = ""  # where the cone tensors of the solve lay

    def __repr__(self):
        return (
            f"Result(status={self.status}, pObj={self.p_obj:+.10e}, "
            f"dObj={self.d_obj:+.10e}, iters={self.n_iters}, "
            f"time={self.solve_time:.2f}s)"
        )


def _host(x) -> np.ndarray:
    profile.count("host_reads")
    return x.detach().cpu().numpy()


class HDSDPSolver:
    """Drives presolve -> 3-phase IPM -> DIMACS check (ref HDSDPOptimize,
    interface/hdsdp.c:647-719) on one device (default "cuda", which
    raises when no card is usable), or, with ``mesh`` (a
    ``parallel.mesh.Mesh``, from ``make_mesh``), on every rank of the mesh
    at once: each rank constructs the solver and calls ``optimize`` alike,
    the device is the mesh's, and a ``device`` that disagrees raises."""

    def __init__(self, prob: SDPProblem, device=None, mesh=None, **param_overrides):
        self.prob = prob
        if mesh is not None:
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != mesh.device.type or want.index not in (
                    None, mesh.device.index)):
                raise ValueError(f"device {device!r} disagrees with the mesh's device "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = mesh
        self.params = Params(**param_overrides)
        self.ipm: Optional[algo.DualIPM] = None
        self._dual_start = None

    def set_dual_start(self, y) -> None:
        """Dual warm start (ref HDSDPSetDualStart, interface/hdsdp.c:617)."""
        self._dual_start = np.asarray(y, dtype=np.float64)

    def optimize(
        self,
        d_only: bool = False,
        resume_from: Optional[str] = None,
        checkpoint_to: Optional[str] = None,
    ) -> Result:
        """Solve; ``resume_from`` seeds the solve with a checkpoint (the
        dual start and both makers) written by either package,
        ``checkpoint_to`` writes one after the IPM ends."""
        with profile.span("solve"):
            return self._optimize(d_only, resume_from, checkpoint_to)

    def _optimize(self, d_only, resume_from, checkpoint_to) -> Result:
        t0 = time.time()
        with profile.span("ipm_setup"):
            ipm = algo.DualIPM(self.prob, self.params, device=self.device, mesh=self.mesh)
            if self._dual_start is not None:
                ipm.y0 = ipm._vec(self._dual_start)
            if resume_from is not None:
                apply_checkpoint(ipm, load_checkpoint(resume_from))
        self.ipm = ipm
        if self.params.verbose:
            print(f"\nhdsdp_tpu_torch: semidefinite programming solver on {self.device}\n")
            if self.params.model_notes:
                print(ipm.params.model_notes)

        ipm.solve(d_only=d_only)

        if checkpoint_to is not None:
            save_checkpoint(checkpoint_to, ipm)

        errs = np.ones(6)
        if ipm.status not in (
            algo.INFEAS_OR_UNBOUNDED,
            algo.SUSPECT_INFEAS_OR_UNBOUNDED,
        ):
            errs = dimacs.check_solution(ipm)

        if self.params.verbose:
            print("DIMACS error metric:\n    " + " ".join(f"{e:5.2e}" for e in errs))
            print(f"\nSDP Status: {ipm.status}")
            print(f"  pObj {ipm.p_obj_val:+15.10e}")
            print(f"  dObj {ipm.d_obj_val:+15.10e}")
            print(f"  Time {time.time() - t0:3.1f} seconds\n")

        return Result(
            status=ipm.status,
            p_obj=ipm.p_obj_val,
            d_obj=ipm.d_obj_val,
            gap=ipm.p_obj_val - ipm.d_obj_val,
            y=_host(ipm.y),
            dimacs=errs,
            n_iters=ipm.n_iter,
            solve_time=time.time() - t0,
            stats=dict(ipm._factor_stats),
            device=str(ipm.cones.groups[0].C.device if ipm.cones.groups
                       else ipm.cones.lp.A.device),
        )

    # -- solution extraction (ref HDSDPGetRowDual / HDSDPGetConeValues) --
    def get_row_dual(self) -> np.ndarray:
        if self.ipm is None:
            raise RuntimeError("call optimize() first")
        return _host(self.ipm.y)

    def get_primal(self):
        """Recovered primal per ORIGINAL block (list of [n, n]) + LP x."""
        if self.ipm is None:
            raise RuntimeError("call optimize() first")
        with profile.span("get_primal"):
            return self._get_primal()

    def _get_primal(self):
        ipm = self.ipm
        if ipm.psdp is not None:  # set only by a refinement that returned its X
            X_groups, x_lp = ipm.psdp.get_primal()
        else:
            maker = ipm.maker_acc if ipm.maker_acc.mu > 0.0 else ipm.maker_inacc
            if maker.mu <= 0.0:
                return None
            rec = dimacs.recover_primal(ipm, maker)
            if rec is None:
                return None
            X_groups, x_lp = rec
        X_by_block = [None] * len(self.prob.block_dims)
        for grp, Xg in zip(self.prob.groups, X_groups):
            for slot, ib in enumerate(grp.block_ids):
                X_by_block[ib] = _host(Xg[slot])
        return X_by_block, (_host(x_lp) if x_lp is not None else None)

    def get_dual_slacks(self):
        """Dual slack S per ORIGINAL block + LP s at the final iterate."""
        if self.ipm is None:
            raise RuntimeError("call optimize() first")
        ipm = self.ipm
        S, s_lp = ipm.cones.assemble(1.0, -1.0, ipm.y, -ipm.Rd + ipm.perturb)
        S_by_block = [None] * len(self.prob.block_dims)
        for grp, Sg in zip(self.prob.groups, S):
            for slot, ib in enumerate(grp.block_ids):
                S_by_block[ib] = _host(Sg[slot])
        return S_by_block, (_host(s_lp) if s_lp is not None else None)


def solve_sdpa_file(path: str, device=None, d_only: bool = False, mesh=None,
                    **param_overrides) -> Result:
    """Read, presolve and solve an SDPA file on ``device`` (default
    "cuda") or on every rank of ``mesh``."""
    solver = HDSDPSolver(SDPProblem.from_sdpa(read_sdpa(path)), device=device, mesh=mesh,
                         **param_overrides)
    return solver.optimize(d_only=d_only)
